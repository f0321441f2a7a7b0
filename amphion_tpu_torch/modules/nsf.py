"""Neural source-filter excitation (port of `amphion_tpu/modules/nsf.py`):
F0 → a stack of harmonic sines plus noise → one tanh-mixed excitation
channel, NSF-HiFiGAN's source.

The phase is the cumulative sum of the per-sample normalised frequency of
each harmonic. ``rng=None`` is the deterministic path: zero initial
phases and no noise. The random path draws the initial phases (uniform,
the fundamental's 0) and the standard normal noise from a
``torch.Generator``, or takes them from the caller (``init_phase=``,
``noise=``), so a test can give it JAX's own draws.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def upsample_f0(f0: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, N) frame-rate F0 → (B, N·hop) sample-rate, nearest neighbour."""
    return torch.repeat_interleave(f0, hop, dim=-1)


class SineGen(nn.Module):
    """Harmonic sines with voiced/unvoiced noise mixing."""

    def __init__(self, sample_rate: int, num_harmonics: int = 7, sine_amp: float = 0.1,
                 noise_std: float = 0.003, voiced_threshold: float = 0.0):
        super().__init__()
        self.sample_rate = sample_rate
        self.num_harmonics = num_harmonics
        self.sine_amp = sine_amp
        self.noise_std = noise_std
        self.voiced_threshold = voiced_threshold

    def draw(self, b: int, t: int, generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
        """(init_phase (b, 1, H+1) uniform with the fundamental's 0, noise
        (b, t, H+1) standard normal) from ``generator``, on its device."""
        h, dev = self.num_harmonics + 1, generator.device
        init_phase = torch.rand((b, 1, h), generator=generator, device=dev)
        init_phase[:, :, 0] = 0.0
        return init_phase, torch.randn((b, t, h), generator=generator, device=dev)

    def forward(self, f0: torch.Tensor, rng: torch.Generator | None = None,
                init_phase: torch.Tensor | None = None, noise: torch.Tensor | None = None):
        """f0 (B, T) sample-rate Hz → (sines (B, T, H+1), uv (B, T))."""
        if rng is not None and (init_phase is None or noise is None):
            init_phase, noise = self.draw(f0.shape[0], f0.shape[1], rng)
        uv = (f0 > self.voiced_threshold).float()
        h = torch.arange(1, self.num_harmonics + 2, dtype=torch.float32, device=f0.device)
        rad = torch.remainder(f0[..., None] * h / self.sample_rate, 1.0)
        phase = torch.remainder(torch.cumsum(rad, dim=1), 1.0)
        if init_phase is not None:
            phase = phase + init_phase
        sines = torch.sin(2.0 * math.pi * phase) * self.sine_amp
        sines = sines * uv[..., None]
        if noise is not None:  # unvoiced: noise at sine_amp/3; voiced: noise_std
            amp = uv[..., None] * self.noise_std + (1 - uv[..., None]) * (self.sine_amp / 3.0)
            sines = sines + amp * noise
        return sines, uv


class SourceModuleHnNSF(nn.Module):
    """The harmonics merged into one excitation channel by the Dense
    ``merge`` and a tanh."""

    def __init__(self, sample_rate: int, num_harmonics: int = 7, sine_amp: float = 0.1,
                 noise_std: float = 0.003):
        super().__init__()
        self.sinegen = SineGen(sample_rate, num_harmonics, sine_amp, noise_std)
        self.merge = nn.Linear(num_harmonics + 1, 1)

    def forward(self, f0: torch.Tensor, rng: torch.Generator | None = None,
                init_phase: torch.Tensor | None = None, noise: torch.Tensor | None = None):
        """f0 (B, T) sample-rate Hz → (excitation (B, T, 1), uv (B, T))."""
        sines, uv = self.sinegen(f0, rng, init_phase, noise)
        return torch.tanh(self.merge(sines)), uv
