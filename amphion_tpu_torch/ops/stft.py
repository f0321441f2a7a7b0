"""Batched STFT / iSTFT on tensors (port of `amphion_tpu/ops/stft.py`).

Same conventions as the JAX module: ``center=False`` with the caller's
``(n_fft - hop)/2`` reflect padding, a periodic Hann window of
``win_size`` zero-padded to ``n_fft``, and the Vocos ``"same"`` iSTFT
that trims ``(win - hop) // 2`` per side. The transforms are written as
matrix products with a windowed-DFT basis built in float64 numpy, so a
float32 call is float32 throughout (no TF32: matmul, not convolution).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_size: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (identical to ``torch.hann_window``)."""
    n = np.arange(win_size, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)).astype(dtype)


def _padded_window(win_size: int, n_fft: int) -> np.ndarray:
    """Window zero-padded symmetrically to n_fft (torch.stft convention)."""
    w = hann_window(win_size)
    if n_fft == win_size:
        return w
    left = (n_fft - win_size) // 2
    return np.pad(w, (left, n_fft - win_size - left))


@functools.lru_cache(maxsize=8)
def _dft_kernel(n_fft: int, win_size: int) -> np.ndarray:
    """Windowed real-DFT basis (2F, n_fft), F = n_fft//2 + 1.

    Rows are [real_0..real_K, imag_0..imag_K]; built in float64, then cast.
    """
    k = np.arange(n_fft // 2 + 1)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    w = _padded_window(win_size, n_fft)
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=0) * w[None, :]
    return basis.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _idft_kernel(n_fft: int, win_size: int) -> np.ndarray:
    """Inverse real-DFT basis (n_fft, 2F) giving windowed time frames."""
    k = np.arange(n_fft // 2 + 1)[None, :]
    n = np.arange(n_fft)[:, None]
    ang = 2.0 * np.pi * k * n / n_fft
    c = np.full(n_fft // 2 + 1, 2.0)
    c[0] = 1.0
    if n_fft % 2 == 0:
        c[-1] = 1.0
    basis = np.concatenate([np.cos(ang) * c / n_fft,
                            -np.sin(ang) * c / n_fft], axis=1)
    w = _padded_window(win_size, n_fft)
    return (basis * w[:, None]).astype(np.float32)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Frame a signal (..., T) into (..., n_frames, frame_length), n_frames
    = 1 + (T − frame_length) // hop (a view)."""
    return x.unfold(-1, frame_length, hop)


def _reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis (numpy ``mode="reflect"``: no edge repeat)."""
    if pad >= y.shape[-1]:
        raise ValueError(
            f"reflect padding of {pad} needs more than {pad} samples, "
            f"got {y.shape[-1]}")
    return F.pad(y.unsqueeze(1), (pad, pad), mode="reflect").squeeze(1)


def _basis(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(arr).to(like.device)


def stft(y: torch.Tensor, n_fft: int, hop_size: int, win_size: int,
         center: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """STFT of (B, T) signals → (real, imag), each (B, F, N)."""
    if y.ndim == 1:
        y = y[None]
    y = y.float()
    if center:
        y = _reflect_pad(y, n_fft // 2)
    frames = frame_signal(y, n_fft, hop_size)  # (B, N, n_fft)
    out = torch.einsum("bnt,ct->bcn", frames, _basis(_dft_kernel(n_fft, win_size), y))
    f = n_fft // 2 + 1
    return out[:, :f], out[:, f:]


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop_size: int,
          win_size: int, length: int | None = None, padding: str = "center",
          frame_lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse STFT with overlap-add and window-sum normalisation.

    Input (B, F, N) real/imag. ``padding="same"`` gives exactly
    ``N * hop`` samples (Vocos); ``"center"`` matches
    ``torch.istft(center=True)``. ``frame_lengths`` (B,) zeroes each row's
    frames past its length and leaves them out of that row's window sum,
    so a padded row decodes as its unpadded self.
    """
    b, _, n_frames = real.shape
    spec = torch.cat([real, imag], dim=1)  # (B, 2F, N)
    frames = torch.einsum("bcn,tc->btn", spec,
                          _basis(_idft_kernel(n_fft, win_size), spec))
    total = n_fft + hop_size * (n_frames - 1)
    w2 = _basis(_padded_window(win_size, n_fft) ** 2, spec)  # (n_fft,)
    wsum = w2[None, :, None].expand(1, n_fft, n_frames)
    if frame_lengths is not None:
        fmask = (torch.arange(n_frames, device=spec.device)[None, :]
                 < frame_lengths.to(spec.device)[:, None]).to(frames.dtype)
        frames = frames * fmask[:, None, :]
        wsum = wsum * fmask[:, None, :]

    def ola(x):  # (B', n_fft, N) → (B', total)
        return F.fold(x, (1, total), (1, n_fft), stride=(1, hop_size))[:, 0, 0]

    sig = ola(frames) / torch.clamp(ola(wsum.contiguous()), min=1e-11)
    start = n_fft // 2 if padding == "center" else (win_size - hop_size) // 2
    if length is None and padding == "same":
        length = n_frames * hop_size
    if length is not None:
        sig = sig[:, start:]
        if sig.shape[-1] < length:
            sig = F.pad(sig, (0, length - sig.shape[-1]))
        return sig[:, :length]
    return sig[:, start: total - n_fft // 2]
