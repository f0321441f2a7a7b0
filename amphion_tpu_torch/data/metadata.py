"""Utterance metadata (the port's copy of `amphion_tpu/data/metadata.py`):
``{train,test}.json`` lists of utterance records with dataset, uid,
speaker or singer, wav path, duration and optional text."""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path


@dataclass
class Utterance:
    dataset: str
    uid: str
    path: str
    duration: float
    index: int = 0
    speaker: str | None = None
    singer: str | None = None
    text: str | None = None
    language: str | None = None
    extras: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = asdict(self)
        extras = d.pop("extras")
        d = {k: v for k, v in d.items() if v is not None}
        d.update(extras)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Utterance":
        known = {f for f in cls.__dataclass_fields__ if f != "extras"}
        kwargs = {k: v for k, v in d.items() if k in known}
        extras = {k: v for k, v in d.items() if k not in known}
        # some reference adapters capitalise the keys; accept both
        for ref_key, our_key in [
            ("Dataset", "dataset"), ("Uid", "uid"), ("Path", "path"),
            ("Duration", "duration"), ("Singer", "singer"), ("Text", "text"),
            ("index", "index"),
        ]:
            if ref_key in extras and our_key not in kwargs:
                kwargs[our_key] = extras.pop(ref_key)
        return cls(**kwargs, extras=extras)


def save_metadata(path: str | Path, utts: list[Utterance]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump([u.to_dict() for u in utts], f, indent=2, ensure_ascii=False)


def load_metadata(path: str | Path) -> list[Utterance]:
    with open(path) as f:
        records = json.load(f)
    return [Utterance.from_dict(r) for r in records]
