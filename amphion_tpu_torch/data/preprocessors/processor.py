"""Corpus adapters: a raw corpus → ``{train,test}.json`` utterance metadata
and ``statistics.json`` (the port's copy of part of
`amphion_tpu/data/preprocessors/processor.py`).

Adapters are registered by dataset name. Ported: ``ljspeech`` (the VITS
and FastSpeech2 recipes' corpus: ``metadata.csv`` of ``id|raw|normalized``
rows beside ``wavs/<id>.wav``, one speaker), ``libritts`` (the codec-LM
recipes' corpus: ``<split>/<spk>/<chapter>/<uid>.wav`` beside
``<uid>.normalized.txt``) and ``audiofolder`` (any folder of wavs with
optional ``.txt``/``.lab`` transcripts). The test split is drawn as in JAX,
from ``random.Random(seed)``, so the port writes JAX's splits. A name JAX
registers but the port does not raises `NotImplementedError` (ROADMAP A6.7);
an unknown name raises `ValueError`, as in JAX.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Callable

from amphion_tpu_torch.data.audio_io import load_wav
from amphion_tpu_torch.data.metadata import Utterance, save_metadata

SUPPORTED_DATASETS: dict[str, Callable] = {}

# registered by the JAX package, not ported
NOT_PORTED = (
    "vctk", "librilight", "hifitts", "opencpop", "m4singer", "opensinger",
    "popbutfy", "popcs", "kising", "csd", "opera", "nus48e", "svcc", "pjs", "vocalist",
    "lijian", "cdmusiceval", "ljspeech_vocoder", "svcceval", "vctkfewsinger", "vctksample",
    "customsvcdataset", "coco", "cocoeval",
)


def register(name: str):
    def deco(fn):
        SUPPORTED_DATASETS[name] = fn
        return fn

    return deco


def _duration(path: Path) -> float:
    try:
        x, sr = load_wav(path)
        return len(x) / sr
    except Exception:
        return 0.0


def _walk_wavs(root: Path, exts=(".wav", ".flac")) -> list[Path]:
    out = []
    for ext in exts:
        out.extend(root.rglob(f"*{ext}"))
    return sorted(p for p in out if p.is_file())


def _finalize(name: str, utts: list[Utterance], output_dir: Path,
              test_fraction: float = 0.02, seed: int = 0):
    for i, u in enumerate(utts):
        u.index = i
    rng = random.Random(seed)
    idx = list(range(len(utts)))
    rng.shuffle(idx)
    n_test = max(1, int(len(utts) * test_fraction)) if utts else 0
    test_ids = set(idx[:n_test])
    train = [u for i, u in enumerate(utts) if i not in test_ids]
    test = [u for i, u in enumerate(utts) if i in test_ids]
    out = output_dir / name
    save_metadata(out / "train.json", train)
    save_metadata(out / "test.json", test)
    stats = {
        "dataset": name,
        "n_utterances": len(utts),
        "n_train": len(train),
        "n_test": len(test),
        "total_hours": sum(u.duration for u in utts) / 3600.0,
    }
    with open(out / "statistics.json", "w") as f:
        json.dump(stats, f, indent=2)
    return train, test


@register("ljspeech")
def ljspeech(input_dir: str, output_dir: str, **kw):
    """LJSpeech: metadata.csv with 'id|raw|normalized' rows (the normalized
    text where present), wavs/<id>.wav; speaker "LJSpeech"."""
    root = Path(input_dir)
    utts = []
    with open(root / "metadata.csv", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) < 2:
                continue
            uid = parts[0]
            text = parts[2] if len(parts) > 2 and parts[2] else parts[1]
            wav = root / "wavs" / f"{uid}.wav"
            if wav.is_file():
                utts.append(Utterance("ljspeech", uid, str(wav), _duration(wav),
                                      speaker="LJSpeech", text=text, language="en"))
    return _finalize("ljspeech", utts, Path(output_dir), **kw)


@register("libritts")
def libritts(input_dir: str, output_dir: str, **kw):
    """LibriTTS: <split>/<spk>/<chapter>/<uid>.wav + .normalized.txt."""
    root = Path(input_dir)
    utts = []
    for wav in _walk_wavs(root):
        text = None
        for cand in (wav.with_suffix(".normalized.txt"), wav.with_suffix(".original.txt")):
            if cand.is_file():
                text = cand.read_text().strip()
                break
        utts.append(Utterance("libritts", wav.stem, str(wav), _duration(wav),
                              speaker=wav.stem.split("_")[0], text=text, language="en"))
    return _finalize("libritts", utts, Path(output_dir), **kw)


@register("audiofolder")
def audiofolder(input_dir: str, output_dir: str, dataset_name: str = "audiofolder", **kw):
    """Any folder of wavs; optional sidecar .txt or .lab transcripts;
    speaker = parent directory name."""
    root = Path(input_dir)
    utts = []
    for wav in _walk_wavs(root):
        text = None
        for ext in (".txt", ".lab"):
            side = wav.with_suffix(ext)
            if side.is_file():
                text = side.read_text().strip()
                break
        uid = "_".join(wav.relative_to(root).with_suffix("").parts)
        utts.append(Utterance(dataset_name, uid, str(wav), _duration(wav),
                              speaker=wav.parent.name, text=text))
    return _finalize(dataset_name, utts, Path(output_dir), **kw)


def preprocess_dataset(dataset: str, input_dir: str, output_dir: str, **kw):
    """Dispatch by dataset name → (train, test) utterances."""
    if dataset in NOT_PORTED:
        raise NotImplementedError(
            f"the {dataset!r} corpus adapter is not ported (ROADMAP A6.7); the port has "
            f"{sorted(SUPPORTED_DATASETS)}")
    if dataset not in SUPPORTED_DATASETS:
        raise ValueError(
            f"unsupported dataset {dataset!r}; supported: "
            f"{sorted(SUPPORTED_DATASETS)} (use 'audiofolder' for custom data)")
    return SUPPORTED_DATASETS[dataset](input_dir, output_dir, **kw)
