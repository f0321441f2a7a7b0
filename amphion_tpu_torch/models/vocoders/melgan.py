"""MelGAN generator (port of `amphion_tpu/models/vocoders/melgan.py`).

Mel (B, N, n_mel) in, ``tanh`` waveform (B, N·hop) out: a reflect-padded
k7 conv, per stage a leaky ReLU (0.2), a transposed conv of kernel 2r and
``n_residual_layers`` resblocks of dilation 1, 3, 9, ... (reflect-padded
dilated k3, k1, plus a learned 1×1 shortcut), then a reflect-padded k7
conv and ``tanh``. For an odd stride the transposed conv's Flax padding
is asymmetric, ``(k−1−p, k−1−r//2)`` with p = r//2 + r%2, which
`WNConvTranspose1d` takes as torch's padding plus an output padding. The
submodules carry the Flax names (``conv_pre``, ``up_i``, ``res_i_j``,
``conv_post``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from amphion_tpu_torch.modules.weight_norm import WNConv1d, WNConvTranspose1d


@dataclass(frozen=True)
class MelGANConfig:
    n_mel: int = 80
    upsample_rates: tuple[int, ...] = (5, 4, 3, 2)
    ngf: int = 32
    n_residual_layers: int = 3

    @property
    def hop_size(self) -> int:
        h = 1
        for r in self.upsample_rates:
            h *= r
        return h


def _reflect(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the time axis of (B, T, C) by ``pad`` on both sides."""
    return F.pad(x.transpose(1, 2), (pad, pad), mode="reflect").transpose(1, 2)


class MelGANResnetBlock(nn.Module):
    def __init__(self, channels: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.conv1 = WNConv1d(channels, channels, 3, dilation, padding=(0, 0))
        self.conv2 = WNConv1d(channels, channels, 1)
        self.shortcut = WNConv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(_reflect(F.leaky_relu(x, 0.2), self.dilation))
        y = self.conv2(F.leaky_relu(y, 0.2))
        return self.shortcut(x) + y


class MelGANGenerator(nn.Module):
    def __init__(self, cfg: MelGANConfig = MelGANConfig()):
        super().__init__()
        self.cfg = c = cfg
        mult = 2 ** len(c.upsample_rates)
        self.conv_pre = WNConv1d(c.n_mel, mult * c.ngf, 7, padding=(0, 0))
        ch = mult * c.ngf
        self.stages = []
        for i, r in enumerate(c.upsample_rates):
            out = (mult // (2 ** (i + 1))) * c.ngf
            k, p = 2 * r, r // 2 + r % 2
            up = WNConvTranspose1d(ch, out, k, r, padding=(k - 1 - p, k - 1 - r // 2))
            self.add_module(f"up_{i}", up)
            blocks = []
            for j in range(c.n_residual_layers):
                block = MelGANResnetBlock(out, 3 ** j)
                self.add_module(f"res_{i}_{j}", block)
                blocks.append(block)
            self.stages.append((up, blocks))
            ch = out
        self.conv_post = WNConv1d(ch, 1, 7, padding=(0, 0))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(_reflect(mel, 3))
        for up, blocks in self.stages:
            x = up(F.leaky_relu(x, 0.2))
            for block in blocks:
                x = block(x)
        x = self.conv_post(_reflect(F.leaky_relu(x, 0.2), 3))
        return torch.tanh(x)[..., 0]
