"""Wav file IO and resampling (the port's copy of the scipy path of
`amphion_tpu/data/audio_io.py`; the JAX package's native C++ reader is not
ported)."""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
from scipy.io import wavfile


def load_wav(path: str | Path, sr: int | None = None) -> tuple[np.ndarray, int]:
    """A wav file as float32 mono in [-1, 1], resampled to ``sr`` if given."""
    file_sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if x.ndim == 2:
        x = x.mean(axis=1)
    if sr is not None and sr != file_sr:
        x = resample(x, file_sr, sr)
        file_sr = sr
    return x, file_sr


def save_wav(path: str | Path, x: np.ndarray, sr: int) -> None:
    """Write a float waveform as PCM16."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    x = np.clip(np.nan_to_num(np.asarray(x, np.float32)), -1.0, 1.0)
    wavfile.write(str(path), sr, (x * 32767.0).astype(np.int16))


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling with the smallest rational ratio."""
    if orig_sr == target_sr:
        return x
    from scipy.signal import resample_poly  # seconds to import: only when resampling

    g = math.gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g).astype(np.float32)
