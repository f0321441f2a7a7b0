"""Phone-duration tooling (port of `amphion_tpu/data/processors/duration.py`):
the Montreal Forced Aligner's corpus layout out, its TextGrids in.

`prepare_mfa_corpus` writes ``<out>/<speaker>/<uid>.{wav,lab}`` for MFA;
`parse_textgrid` reads one tier of a long-format Praat TextGrid (what MFA
writes) with a native parser; `textgrid_to_durations` turns the phone tier
into integer frame durations for FastSpeech2.
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path

import numpy as np

from amphion_tpu_torch.data.audio_io import load_wav, save_wav
from amphion_tpu_torch.data.metadata import Utterance


def prepare_mfa_corpus(utterances: list[Utterance], output_dir: str | Path,
                       sample_rate: int | None = None) -> Path:
    """Export ``<out>/<speaker>/<uid>.{wav,lab}`` for MFA (utterances
    without text are skipped; a wav is resampled to ``sample_rate`` if given,
    else copied)."""
    out = Path(output_dir)
    for u in utterances:
        if not u.text:
            continue
        d = out / (u.speaker or u.singer or "spk")
        d.mkdir(parents=True, exist_ok=True)
        if sample_rate is not None:
            x, _ = load_wav(u.path, sr=sample_rate)
            save_wav(d / f"{u.uid}.wav", x, sample_rate)
        else:
            shutil.copy(u.path, d / f"{u.uid}.wav")
        (d / f"{u.uid}.lab").write_text(u.text.strip() + "\n")
    return out


def parse_textgrid(path: str | Path, tier_name: str = "phones") -> list[tuple[float, float, str]]:
    """One tier of a long-format Praat TextGrid → [(xmin, xmax, label)]."""
    text = Path(path).read_text(encoding="utf-8", errors="replace")
    target = None
    for block in re.split(r'item\s*\[\d+\]:', text)[1:]:
        m = re.search(r'name\s*=\s*"([^"]*)"', block)
        if m and m.group(1) == tier_name:
            target = block
            break
    if target is None:
        raise ValueError(f"tier {tier_name!r} not found in {path}")
    return [(float(m.group(1)), float(m.group(2)), m.group(3)) for m in re.finditer(
        r'intervals\s*\[\d+\]:\s*xmin\s*=\s*([\d.eE+-]+)\s*xmax\s*=\s*'
        r'([\d.eE+-]+)\s*text\s*=\s*"([^"]*)"', target)]


def textgrid_to_durations(path: str | Path, hop_size: int, sample_rate: int,
                          tier_name: str = "phones",
                          silence_labels: tuple = ("", "sil", "sp", "spn"),
                          ) -> tuple[list[str], np.ndarray]:
    """A TextGrid's phone tier → (phones, int32 frame durations): each
    interval's rounded end frame minus its rounded start frame, so the
    durations sum to the last interval's rounded end; silence labels become
    ``"sil"``."""
    fps = sample_rate / hop_size
    phones, durs = [], []
    for xmin, xmax, label in parse_textgrid(path, tier_name):
        lab = label.strip()
        phones.append(lab if lab not in silence_labels else "sil")
        durs.append(int(round(xmax * fps)) - int(round(xmin * fps)))
    return phones, np.maximum(np.asarray(durs, np.int32), 0)
