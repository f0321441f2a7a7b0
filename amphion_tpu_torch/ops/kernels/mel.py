"""Fused log-mel front end: kernel 3 (`csrc/mel.cu`) and its plain version.

Port of `mel_spectrogram_pallas` (amphion_tpu/ops/pallas_kernels.py:372).
`log_mel` computes ``log(max(mel @ |STFT(reflect_pad(y))|, clip))`` as
(B, n_mel, T // hop) float32. On a CUDA tensor it launches the kernel, a
real FFT in shared memory, which takes n_fft a power of two from 256 to
2048; on a CPU tensor it runs `log_mel_ref`, the same function as a direct
windowed DFT in plain PyTorch. `log_mel_f64` is that arithmetic in float64,
the yardstick both are held against on the card.
"""

from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from amphion_tpu_torch.ops.kernels._build import Fl, I, Kernel, P, no_backward
from amphion_tpu_torch.ops.stft import _dft_kernel, _padded_window, _reflect_pad

MEL = Kernel("mel", {"mel_fwd": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, Fl, P]})
N_FFT_RANGE = (256, 2048)  # the kernel's n_fft: a power of two in this range


def log_mel_ref(y: torch.Tensor, fbank: torch.Tensor, n_fft: int, hop: int,
                win_size: int, clip_val: float) -> torch.Tensor:
    """Plain version: pad, frame, windowed DFT, magnitude, mel, log."""
    pad = (n_fft - hop) // 2
    frames = _reflect_pad(y.float(), pad).unfold(-1, n_fft, hop)  # (B, N, n_fft)
    basis = torch.from_numpy(_dft_kernel(n_fft, win_size)).to(y.device)
    spec = torch.einsum("bnt,ct->bcn", frames, basis)  # (B, 2F, N)
    f = n_fft // 2 + 1
    re, im = spec[:, :f], spec[:, f:]
    mag = torch.sqrt(re * re + im * im + 1e-6)
    mel = torch.einsum("mf,bfn->bmn", fbank, mag)
    return torch.log(torch.clamp(mel, min=clip_val))


def log_mel_f64(y: torch.Tensor, fbank: torch.Tensor, n_fft: int, hop: int,
                win_size: int, clip_val: float) -> torch.Tensor:
    """`log_mel_ref`'s arithmetic in float64: signal, windowed DFT basis
    (built in float64, not rounded to float32) and filterbank; float64 out."""
    pad = (n_fft - hop) // 2
    frames = _reflect_pad(y.double(), pad).unfold(-1, n_fft, hop)
    k = np.arange(n_fft // 2 + 1)[:, None]
    ang = 2.0 * np.pi * k * np.arange(n_fft)[None, :] / n_fft
    w = _padded_window(win_size, n_fft).astype(np.float64)
    basis = torch.from_numpy(np.concatenate([np.cos(ang), -np.sin(ang)]) * w).to(y.device)
    spec = torch.einsum("bnt,ct->bcn", frames, basis)
    f = n_fft // 2 + 1
    re, im = spec[:, :f], spec[:, f:]
    mel = torch.einsum("mf,bfn->bmn", fbank.double(), torch.sqrt(re * re + im * im + 1e-6))
    return torch.log(torch.clamp(mel, min=clip_val))


def fft_tables(n_fft: int, win_size: int) -> tuple[int, int, np.ndarray, np.ndarray]:
    """(tap0, ntaps, window, twiddles): the padded Hann window's nonzero
    taps [tap0, tap0 + ntaps) as float32, and W_n^e = exp(-2πi e / n) for
    e < n = n_fft as (n, 2) float32 (re, im), computed in float64."""
    w = _padded_window(win_size, n_fft)
    nz = np.flatnonzero(w)
    tap0, ntaps = int(nz[0]), int(nz[-1] - nz[0] + 1)
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    tw = np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)
    return tap0, ntaps, w[tap0: tap0 + ntaps].astype(np.float32), tw


def band_tables(fbank: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(bands, weights) of a (n_mel, F) filterbank: bands (n_mel, 3) int32
    holds each band's first nonzero bin, its count of bins up to its last
    nonzero one, and its offset into weights, which holds those bins'
    weights band after band (an all-zero band has count 0)."""
    bands = np.zeros((fbank.shape[0], 3), np.int32)
    weights = []
    off = 0
    for m, row in enumerate(fbank):
        nz = np.flatnonzero(row)
        first, count = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        bands[m] = first, count, off
        weights.append(row[first: first + count])
        off += count
    return bands, np.concatenate(weights).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _device_fft_tables(n_fft: int, win_size: int, device: torch.device):
    tap0, ntaps, win, tw = fft_tables(n_fft, win_size)
    return tap0, ntaps, torch.from_numpy(win).to(device), torch.from_numpy(tw).to(device)


_BANDS: dict = {}  # id(fbank) → (weak reference, version, bands, weights)


def _device_band_tables(fbank: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`band_tables` of ``fbank`` on its device, kept while the tensor lives
    and is not changed in place (its version counter)."""
    hit = _BANDS.get(id(fbank))
    if hit is None or hit[0]() is not fbank or hit[1] != fbank._version:
        bands, weights = band_tables(fbank.detach().cpu().numpy())
        hit = (weakref.ref(fbank), fbank._version, torch.from_numpy(bands).to(fbank.device),
               torch.from_numpy(weights).to(fbank.device))
        _BANDS[id(fbank)] = hit
    return hit[2], hit[3]


def log_mel(y: torch.Tensor, fbank: torch.Tensor, n_fft: int, hop: int,
            win_size: int, clip_val: float) -> torch.Tensor:
    """y (B, T) float32 → (B, n_mel, T // hop) float32 log-mel."""
    if y.ndim != 2 or y.dtype != torch.float32:
        raise ValueError(f"log_mel takes (B, T) float32, got {tuple(y.shape)} {y.dtype}")
    pad = (n_fft - hop) // 2
    if (n_fft - hop) % 2 or y.shape[1] <= pad or y.shape[1] < hop or win_size > n_fft:
        raise ValueError(
            f"log_mel needs an even n_fft - hop, win_size <= n_fft and more than {pad} "
            f"samples, got n_fft={n_fft} hop={hop} win_size={win_size} T={y.shape[1]}")
    if y.device.type == "cpu":
        return log_mel_ref(y, fbank, n_fft, hop, win_size, clip_val)
    if y.device.type != "cuda":
        raise ValueError(f"log_mel runs on cuda or cpu, not {y.device}")
    lo, hi = N_FFT_RANGE
    if not lo <= n_fft <= hi or n_fft & (n_fft - 1):
        raise ValueError(f"the mel kernel takes n_fft a power of two from {lo} to {hi}, "
                         f"got {n_fft}")
    no_backward("log_mel", y, fbank)
    n_mel, f = fbank.shape
    if (f != n_fft // 2 + 1 or fbank.dtype != torch.float32
            or fbank.device != y.device or not fbank.is_contiguous()):
        raise ValueError("fbank must be a contiguous float32 (n_mel, n_fft//2+1) "
                         "tensor on the signal's device")
    y = y.contiguous()
    b, t = y.shape
    n = t // hop
    tap0, ntaps, win, tw = _device_fft_tables(n_fft, win_size, y.device)
    bands, weights = _device_band_tables(fbank)
    out = torch.empty((b, n_mel, n), dtype=torch.float32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    MEL.launch("mel_fwd", y.data_ptr(), win.data_ptr(), tw.data_ptr(), bands.data_ptr(),
               weights.data_ptr(), out.data_ptr(), b, t, n, n_fft, hop, pad, tap0, ntaps,
               n_mel, float(clip_val), stream)
    return out
