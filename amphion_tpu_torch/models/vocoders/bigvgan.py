"""BigVGAN generator: HiFi-GAN topology with anti-aliased periodic
activations (port of `amphion_tpu/models/vocoders/bigvgan.py`).

Mel (B, T, n_mel) in, ``tanh`` waveform (B, T·hop) out, as in JAX. The
submodules carry the Flax scope names (``Conv_0``, ``ConvTranspose_i``,
``amp_{stage}_{kernel}``, ``SnakeBeta_j``); the weight-norm scales live on
the conv modules and `utils/convert.from_flax` reads them from Flax's
``WeightNorm_k`` scopes. With ``use_pallas_act`` every activation (73 at
the default config: 4 stages × 3 AMP blocks × 3 dilations × 2, plus the
final one) runs kernel 2 on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from amphion_tpu_torch.modules.activations import Snake, SnakeBeta
from amphion_tpu_torch.modules.anti_aliasing import Activation1d
from amphion_tpu_torch.modules.weight_norm import WNConv1d, WNConvTranspose1d


@dataclass(frozen=True)
class BigVGANConfig:
    n_mel: int = 80
    upsample_rates: tuple[int, ...] = (5, 4, 3, 2)
    upsample_kernel_sizes: tuple[int, ...] = (10, 8, 6, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5),
    )
    activation: str = "snakebeta"  # "snake" | "snakebeta"
    snake_logscale: bool = True
    use_pallas_act: bool = False  # the fused anti-aliased activation (kernel 2)

    @property
    def hop_size(self) -> int:
        h = 1
        for r in self.upsample_rates:
            h *= r
        return h


def _activation(kind: str, channels: int, logscale: bool) -> nn.Module:
    return (SnakeBeta if kind == "snakebeta" else Snake)(channels, alpha_logscale=logscale)


class AMPBlock(nn.Module):
    """Dilated conv resblock with anti-aliased Snake activations: per
    dilation, act → conv (dilated) → act → conv, plus the residual."""

    def __init__(self, channels: int, kernel_size: int, dilations: tuple[int, ...],
                 activation: str, logscale: bool = True, use_pallas: bool = False):
        super().__init__()
        prefix = "SnakeBeta" if activation == "snakebeta" else "Snake"
        self.acts = []
        for j, d in enumerate(dilations):
            for half, dil in ((2 * j, d), (2 * j + 1, 1)):
                act = _activation(activation, channels, logscale)
                self.add_module(f"{prefix}_{half}", act)
                self.acts.append(Activation1d(act, use_pallas=use_pallas))
                self.add_module(f"Conv_{half}", WNConv1d(channels, channels, kernel_size, dil))
        self.convs = [getattr(self, f"Conv_{i}") for i in range(2 * len(dilations))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j in range(len(self.convs) // 2):
            y = self.convs[2 * j](self.acts[2 * j](x))
            y = self.convs[2 * j + 1](self.acts[2 * j + 1](y))
            x = x + y
        return x


class BigVGANGenerator(nn.Module):
    def __init__(self, cfg: BigVGANConfig = BigVGANConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.Conv_0 = WNConv1d(c.n_mel, c.upsample_initial_channel, 7)
        ch = c.upsample_initial_channel
        self.stages = []
        for i, (rate, kernel) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            out = c.upsample_initial_channel // (2 ** (i + 1))
            up = WNConvTranspose1d(ch, out, kernel, rate)
            self.add_module(f"ConvTranspose_{i}", up)
            blocks = []
            for ks, ds in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                block = AMPBlock(out, ks, tuple(ds), c.activation, logscale=c.snake_logscale,
                                 use_pallas=c.use_pallas_act)
                self.add_module(f"amp_{i}_{ks}", block)
                blocks.append(block)
            self.stages.append((up, blocks))
            ch = out
        prefix = "SnakeBeta" if c.activation == "snakebeta" else "Snake"
        act = _activation(c.activation, ch, c.snake_logscale)
        self.add_module(f"{prefix}_0", act)
        self.final_act = Activation1d(act, use_pallas=c.use_pallas_act)
        self.Conv_1 = WNConv1d(ch, 1, 7)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(mel)
        for up, blocks in self.stages:
            x = up(x)
            acc = None
            for block in blocks:
                out = block(x)
                acc = out if acc is None else acc + out
            x = acc / len(blocks)
        x = self.Conv_1(self.final_act(x))
        return torch.tanh(x)[..., 0]
