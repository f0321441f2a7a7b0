"""Offline acoustic features (port of
`amphion_tpu/data/processors/acoustic.py`), batched on the device.

Utterances are cut to a whole number of hops, grouped by
`data/samplers.LengthBucketSampler` (samples a batch, no shuffle) and
zero-padded to their bucket, as in JAX; each batch's log-mel runs kernel 3
on the card (`ops/mel.mel_spectrogram`), F0 and voicing `ops/f0.yin_f0`,
energy `ops/energy.energy_from_log_mel`. Each utterance's frames go to
``mels/``, ``f0/``, ``uv/`` and ``energy/<uid>.npy`` beside the statistics
JAX writes (mel min/max per bin, pitch statistics per speaker). The pYIN
tracker is not ported and raises (ROADMAP A6.7).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from amphion_tpu_torch.data.audio_io import load_wav
from amphion_tpu_torch.data.metadata import Utterance
from amphion_tpu_torch.data.samplers import LengthBucketSampler
from amphion_tpu_torch.ops.energy import energy_from_log_mel
from amphion_tpu_torch.ops.f0 import F0Config, yin_f0
from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram
from amphion_tpu_torch.utils.device import resolve_device


@torch.inference_mode()
def extract_acoustic_features(utterances: list[Utterance], output_dir: str | Path,
                              mel_cfg: MelConfig, extract_f0: bool = True,
                              extract_energy: bool = True,
                              max_tokens: int = 4_000_000,  # samples per device batch
                              pitch_extractor: str = "yin", device=None) -> dict:
    """Mel (+F0/UV, energy) of every utterance → .npy files on ``device``
    (``cuda`` unless named). Returns the statistics (also written)."""
    if extract_f0 and pitch_extractor != "yin":
        raise NotImplementedError(f"pitch_extractor {pitch_extractor!r} is not ported "
                                  "(ROADMAP A6.7); the port has 'yin'")
    device = resolve_device(device)
    out = Path(output_dir)
    for d in ("mels", "f0", "uv", "energy"):
        (out / d).mkdir(parents=True, exist_ok=True)

    hop = mel_cfg.hop_size
    audios = []
    for u in utterances:
        x, _ = load_wav(u.path, sr=mel_cfg.sample_rate)
        audios.append(x[: len(x) // hop * hop])
    lengths = [max(len(a), hop) for a in audios]
    sampler = LengthBucketSampler(lengths, max_tokens=max_tokens, shuffle=False)

    mel_min = np.full(mel_cfg.n_mel, np.inf)
    mel_max = np.full(mel_cfg.n_mel, -np.inf)
    pitch_stats: dict[str, list] = {}
    f0_cfg = F0Config(sample_rate=mel_cfg.sample_rate, hop_size=hop)
    for idxs, bucket in sampler:
        batch = np.zeros((len(idxs), bucket), np.float32)
        for row, i in enumerate(idxs):
            batch[row, : len(audios[i])] = audios[i]
        y = torch.from_numpy(batch).to(device)
        mel_t = mel_spectrogram(y, mel_cfg)
        mel = mel_t.cpu().numpy()
        if extract_f0:
            f0, voiced = (a.cpu().numpy() for a in yin_f0(y, f0_cfg))
        if extract_energy:
            energy = energy_from_log_mel(mel_t).cpu().numpy()
        for row, i in enumerate(idxs):
            u = utterances[i]
            n = lengths[i] // hop
            m = mel[row, :, :n]
            np.save(out / "mels" / f"{u.uid}.npy", m)
            mel_min = np.minimum(mel_min, m.min(axis=1))
            mel_max = np.maximum(mel_max, m.max(axis=1))
            if extract_f0:
                np.save(out / "f0" / f"{u.uid}.npy", f0[row, :n])
                np.save(out / "uv" / f"{u.uid}.npy", voiced[row, :n])
                voiced_f0 = f0[row, :n][voiced[row, :n]]
                if voiced_f0.size:
                    key = u.singer or u.speaker or "default"
                    pitch_stats.setdefault(key, []).append(voiced_f0)
            if extract_energy:
                np.save(out / "energy" / f"{u.uid}.npy", energy[row, :n])

    stats = {"mel_min": mel_min.tolist(), "mel_max": mel_max.tolist(), "pitch": {}}
    for key, chunks in pitch_stats.items():
        allf0 = np.concatenate(chunks)
        stats["pitch"][key] = {"mean": float(allf0.mean()), "std": float(allf0.std()),
                               "min": float(allf0.min()), "max": float(allf0.max()),
                               "median": float(np.median(allf0))}
    with open(out / "statistics.json", "w") as f:
        json.dump(stats, f, indent=2)
    return stats
