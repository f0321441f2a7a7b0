"""HiFi-GAN generator (port of `amphion_tpu/models/vocoders/hifigan.py`).

Mel (B, N, n_mel) in, ``tanh`` waveform (B, N·hop) out, as in JAX: a
k7 conv, per stage a leaky ReLU, a transposed conv and the mean of the
multi-receptive-field resblocks, then a leaky ReLU of slope 0.01 (the
reference's ``F.leaky_relu`` default), a k7 conv and ``tanh``. Every
convolution is weight-normalised with Flax's rules (`modules/weight_norm.py`)
and the submodules carry the Flax auto-names (``Conv_0``,
``ConvTranspose_i``, ``ResBlock1_k`` numbered across stages, ``cond``),
so `utils/convert.from_flax` carries a JAX tree over. The resblocks are
shared with APNet and NSF-HiFiGAN.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from amphion_tpu_torch.modules.weight_norm import WNConv1d, WNConvTranspose1d

LRELU_SLOPE = 0.1


@dataclass(frozen=True)
class HiFiGANConfig:
    resblock: str = "1"  # "1" (V1/V2) or "2" (V3)
    upsample_rates: tuple[int, ...] = (5, 4, 3, 2)
    upsample_kernel_sizes: tuple[int, ...] = (10, 8, 6, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5),
    )
    n_mel: int = 80

    @classmethod
    def from_model_cfg(cls, m: dict, n_mel: int = 80) -> "HiFiGANConfig":
        """From a ``cfg["model"]["hifigan"]`` block."""
        return cls(
            resblock=str(m["resblock"]),
            upsample_rates=tuple(m["upsample_rates"]),
            upsample_kernel_sizes=tuple(m["upsample_kernel_sizes"]),
            upsample_initial_channel=m["upsample_initial_channel"],
            resblock_kernel_sizes=tuple(m["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(tuple(d) for d in m["resblock_dilation_sizes"]),
            n_mel=n_mel,
        )

    @property
    def hop_size(self) -> int:
        h = 1
        for r in self.upsample_rates:
            h *= r
        return h


class ResBlock1(nn.Module):
    """V1/V2 resblock: per dilation, leaky ReLU → dilated conv → leaky ReLU
    → conv, plus the residual (``Conv_{2j}``, ``Conv_{2j+1}``)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        for j, d in enumerate(dilation):
            self.add_module(f"Conv_{2 * j}", WNConv1d(channels, channels, kernel_size, d))
            self.add_module(f"Conv_{2 * j + 1}", WNConv1d(channels, channels, kernel_size))
        self.convs = [getattr(self, f"Conv_{i}") for i in range(2 * len(dilation))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(len(self.convs) // 2):
            xt = self.convs[2 * j](F.leaky_relu(x, LRELU_SLOPE))
            x = x + self.convs[2 * j + 1](F.leaky_relu(xt, LRELU_SLOPE))
        return x


class ResBlock2(nn.Module):
    """V3 resblock: one dilated conv per dilation, plus the residual."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: tuple[int, ...] = (1, 3)):
        super().__init__()
        for j, d in enumerate(dilation):
            self.add_module(f"Conv_{j}", WNConv1d(channels, channels, kernel_size, d))
        self.convs = [getattr(self, f"Conv_{j}") for j in range(len(dilation))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = x + conv(F.leaky_relu(x, LRELU_SLOPE))
        return x


def resblock_class(cfg: HiFiGANConfig) -> type:
    return ResBlock1 if cfg.resblock == "1" else ResBlock2


def mrf(blocks: list[nn.Module], x: torch.Tensor) -> torch.Tensor:
    """The multi-receptive-field fusion: the mean of the resblocks' outputs."""
    acc = None
    for block in blocks:
        out = block(x)
        acc = out if acc is None else acc + out
    return acc / len(blocks)


class HiFiGANGenerator(nn.Module):
    """mel (B, N, n_mel) → waveform (B, N·hop) in [-1, 1]. With
    ``gin_channels`` the forward takes global conditioning ``g`` (B, 1,
    gin_channels), added after the first conv through the Dense ``cond``
    (the VITS decoder's speaker conditioning)."""

    def __init__(self, cfg: HiFiGANConfig = HiFiGANConfig(), gin_channels: int = 0):
        super().__init__()
        self.cfg = c = cfg
        self.Conv_0 = WNConv1d(c.n_mel, c.upsample_initial_channel, 7)
        if gin_channels:
            self.cond = nn.Linear(gin_channels, c.upsample_initial_channel)
        block_cls = resblock_class(c)
        ch, k = c.upsample_initial_channel, 0
        self.stages = []
        for i, (rate, kernel) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            out = c.upsample_initial_channel // (2 ** (i + 1))
            up = WNConvTranspose1d(ch, out, kernel, rate)
            self.add_module(f"ConvTranspose_{i}", up)
            blocks = []
            for ks, ds in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                block = block_cls(out, ks, tuple(ds))
                self.add_module(f"{block_cls.__name__}_{k}", block)
                blocks.append(block)
                k += 1
            self.stages.append((up, blocks))
            ch = out
        self.Conv_1 = WNConv1d(ch, 1, 7)

    def forward(self, mel: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
        x = self.Conv_0(mel)
        if g is not None:
            if not hasattr(self, "cond"):
                raise ValueError("HiFiGANGenerator: g given, but built without gin_channels")
            x = x + self.cond(g)
        for up, blocks in self.stages:
            x = mrf(blocks, up(F.leaky_relu(x, LRELU_SLOPE)))
        x = self.Conv_1(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[..., 0]
