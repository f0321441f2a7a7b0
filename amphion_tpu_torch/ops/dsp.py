"""Griffin-Lim and the vocoder-free mel inversion (port of `griffin_lim` and
`mel_to_audio` of `amphion_tpu/ops/dsp.py`; its other helpers are not
ported): FastSpeech2's two-stage inference without a vocoder checkpoint.

Plain PyTorch on either device over `ops/stft` (a centered STFT, the
``"center"`` iSTFT), as JAX runs it with XLA. JAX draws the initial phase
from ``jax.random.key(0)``; the port takes it as ``init_phase`` or draws it
from a generator seeded 0 on the magnitude's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from amphion_tpu_torch.ops.mel import mel_filterbank
from amphion_tpu_torch.ops.stft import istft, stft


def griffin_lim(magnitude: torch.Tensor, n_fft: int, hop_size: int, win_size: int,
                n_iters: int = 32, init_phase: torch.Tensor | None = None) -> torch.Tensor:
    """Phase reconstruction from |STFT| (B, F, N) → (B, hop · (N − 1)):
    ``n_iters`` rounds of iSTFT then the STFT's phase, then a last iSTFT.
    ``init_phase`` (B, F, N) defaults to a uniform draw on [0, 2π)."""
    n = magnitude.shape[-1]
    length = hop_size * (n - 1)
    if init_phase is None:
        g = torch.Generator(magnitude.device).manual_seed(0)
        init_phase = torch.rand(magnitude.shape, generator=g, device=magnitude.device) * (
            2 * math.pi)

    def inverse(phase):
        return istft(magnitude * torch.cos(phase), magnitude * torch.sin(phase), n_fft,
                     hop_size, win_size, length=length)

    phase = init_phase
    for _ in range(n_iters):
        re, im = stft(inverse(phase), n_fft, hop_size, win_size, center=True)
        phase = torch.atan2(im, re)
    return inverse(phase)


def mel_to_audio(log_mel: torch.Tensor, cfg, n_iters: int = 32,
                 init_phase: torch.Tensor | None = None) -> torch.Tensor:
    """Invert a log-mel (B, n_mel, N) through the filterbank's
    pseudo-inverse and Griffin-Lim → (B, hop · (N − 1)); ``cfg`` is a
    `MelConfig`. The log-mel is clipped to [−12, 6] first (exp overflow)."""
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mel, cfg.fmin, cfg.fmax)
    pinv = torch.from_numpy(np.linalg.pinv(fb)).to(log_mel.device)  # (F, n_mel)
    mel = torch.exp(torch.clamp(log_mel, -12.0, 6.0))
    mag = torch.clamp(torch.einsum("fm,bmn->bfn", pinv, mel), min=1e-8)
    return griffin_lim(mag, cfg.n_fft, cfg.hop_size, cfg.win_size, n_iters, init_phase)
