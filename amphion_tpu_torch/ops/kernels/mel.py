"""Fused log-mel front end: kernel 3 (`csrc/mel.cu`) and its plain version.

Port of `mel_spectrogram_pallas` (amphion_tpu/ops/pallas_kernels.py:372).
`log_mel` computes ``log(max(mel @ |STFT(reflect_pad(y))|, clip))`` as
(B, n_mel, T // hop) float32. On a CUDA tensor it launches the kernel; on a
CPU tensor it runs `log_mel_ref`, the same arithmetic in plain PyTorch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from amphion_tpu_torch.ops.kernels._build import Fl, I, Kernel, P, no_backward
from amphion_tpu_torch.ops.stft import _dft_kernel, _reflect_pad

MEL = Kernel("mel", {"mel_fwd": [P, P, P, P, I, I, I, I, I, I, I, I, I, Fl, P]})


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


@functools.lru_cache(maxsize=8)
def _tap_basis(n_fft: int, win_size: int, device: torch.device):
    """(tap0, ntaps, basis) with basis (ntaps, 2F): the windowed DFT over the
    window's nonzero taps only, tap-major for coalesced reads."""
    full = _dft_kernel(n_fft, win_size)  # (2F, n_fft)
    nz = np.flatnonzero(np.any(full != 0, axis=0))
    tap0, ntaps = int(nz[0]), int(nz[-1] - nz[0] + 1)
    basis = np.ascontiguousarray(full[:, tap0: tap0 + ntaps].T)
    return tap0, ntaps, torch.from_numpy(basis).to(device)


def log_mel(y: torch.Tensor, fbank: torch.Tensor, n_fft: int, hop: int,
            win_size: int, clip_val: float) -> torch.Tensor:
    """y (B, T) float32 → (B, n_mel, T // hop) float32 log-mel."""
    if y.ndim != 2 or y.dtype != torch.float32:
        raise ValueError(f"log_mel takes (B, T) float32, got {tuple(y.shape)} {y.dtype}")
    pad = (n_fft - hop) // 2
    if (n_fft - hop) % 2 or y.shape[1] <= pad or y.shape[1] < hop:
        raise ValueError(
            f"log_mel needs an even n_fft - hop and more than {pad} samples, "
            f"got n_fft={n_fft} hop={hop} T={y.shape[1]}")
    if y.device.type == "cpu":
        return log_mel_ref(y, fbank, n_fft, hop, win_size, clip_val)
    if y.device.type != "cuda":
        raise ValueError(f"log_mel runs on cuda or cpu, not {y.device}")
    no_backward("log_mel", y, fbank)
    n_mel, f = fbank.shape
    if (f != n_fft // 2 + 1 or fbank.dtype != torch.float32
            or fbank.device != y.device or not fbank.is_contiguous()):
        raise ValueError("fbank must be a contiguous float32 (n_mel, n_fft//2+1) "
                         "tensor on the signal's device")
    y = y.contiguous()
    b, t = y.shape
    n = t // hop
    tap0, ntaps, basis = _tap_basis(n_fft, win_size, y.device)
    out = torch.empty((b, n_mel, n), dtype=torch.float32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    MEL.launch("mel_fwd", y.data_ptr(), basis.data_ptr(), fbank.data_ptr(),
               out.data_ptr(), b, t, n, hop, pad, tap0, ntaps, f, n_mel,
               float(clip_val), stream)
    return out
