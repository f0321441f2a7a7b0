"""Vocos vocoder: ConvNeXt backbone + iSTFT head (port of
`amphion_tpu/models/vocoders/vocos.py`). Mel in (B, N, n_mel) as in JAX.
Vevo's vocoder and the GAN trainer's ``vocos`` generator.

Numerics kept from Flax: LayerNorm eps 1e-6, ``"SAME"`` convolution padding,
exact (erf) GELU, log-magnitude head clipped at 1e2.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from amphion_tpu_torch.ops.stft import istft


@dataclass(frozen=True)
class VocosConfig:
    n_mel: int = 80
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_fft: int = 1024
    hop_size: int = 256


def _conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Conv1d on a (B, T, C) tensor."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int, layer_scale: float = 1e-6):
        super().__init__()
        self.Conv_0 = nn.Conv1d(dim, dim, 7, padding="same", groups=dim)
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-6)
        self.Dense_0 = nn.Linear(dim, intermediate_dim)
        self.Dense_1 = nn.Linear(intermediate_dim, dim)
        self.layer_scale = layer_scale
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale))

    def forward(self, x, mask=None):
        # zero padded positions before the depthwise conv, so a ragged row
        # sees the same zero boundary as an unpadded decode
        if mask is not None:
            x = x * mask
        y = self.LayerNorm_0(_conv(self.Conv_0, x))
        y = self.Dense_1(F.gelu(self.Dense_0(y)))
        return x + self.gamma * y


class VocosGenerator(nn.Module):
    def __init__(self, cfg: VocosConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Conv1d(cfg.n_mel, cfg.dim, 7, padding="same")
        self.norm_pre = nn.LayerNorm(cfg.dim, eps=1e-6)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", ConvNeXtBlock(cfg.dim, cfg.intermediate_dim))
        self.norm_post = nn.LayerNorm(cfg.dim, eps=1e-6)
        self.head = nn.Linear(cfg.dim, 2 * (cfg.n_fft // 2 + 1))

    def forward(self, mel: torch.Tensor,
                frame_lengths: torch.Tensor | None = None) -> torch.Tensor:
        """mel (B, N, n_mel) → waveform (B, N * hop). With ``frame_lengths``
        (B,), ``out[i, :frame_lengths[i] * hop]`` equals row i decoded alone."""
        c = self.cfg
        mask = None
        if frame_lengths is not None:
            mask = (torch.arange(mel.shape[1], device=mel.device)[None, :]
                    < frame_lengths.to(mel.device)[:, None]).to(mel.dtype)[:, :, None]
            mel = mel * mask
        x = self.norm_pre(_conv(self.embed, mel))
        for i in range(c.num_layers):
            x = getattr(self, f"block_{i}")(x, mask)
        mag, phase = self.head(self.norm_post(x)).chunk(2, dim=-1)
        mag = torch.clamp(torch.exp(mag), max=1e2)
        real = (mag * torch.cos(phase)).transpose(1, 2)
        imag = (mag * torch.sin(phase)).transpose(1, 2)
        n = mel.shape[1]
        return istft(real, imag, c.n_fft, c.hop_size, c.n_fft,
                     length=n * c.hop_size, padding="same",
                     frame_lengths=frame_lengths)
