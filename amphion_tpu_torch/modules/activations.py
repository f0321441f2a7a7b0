"""Periodic activations Snake and SnakeBeta (port of
`amphion_tpu/modules/activations.py`; BigVGAN family).

``x + sin²(αx)/α`` (Snake) and ``x + sin²(αx)/β`` (SnakeBeta) per channel
on the last axis, with α (and β) optionally kept in log scale and
exponentiated before use. ``use_pallas`` runs Snake through kernel 1
(`ops/kernels/snake.py`, forward and backward); ``fused_aa=True`` runs
the anti-aliased chain up 2x → activation → down 2x through kernel 2
(`ops/kernels/aa_snake.py`; Snake passes α as β). The parameter names are
the Flax ones (``alpha``, ``beta``).
"""

from __future__ import annotations

import torch
from torch import nn

from amphion_tpu_torch.ops.kernels.aa_snake import AASnakeBetaFn, aa_snake
from amphion_tpu_torch.ops.kernels.snake import SnakeFn


def _init(channels: int, logscale: bool) -> nn.Parameter:
    return nn.Parameter(torch.zeros(channels) if logscale else torch.ones(channels))


class Snake(nn.Module):
    def __init__(self, channels: int, alpha_logscale: bool = False, use_pallas: bool = False):
        super().__init__()
        self.channels = channels
        self.alpha_logscale = alpha_logscale
        self.use_pallas = use_pallas
        self.alpha = _init(channels, alpha_logscale)

    def forward(self, x: torch.Tensor, fused_aa: bool = False) -> torch.Tensor:
        alpha = torch.exp(self.alpha) if self.alpha_logscale else self.alpha
        if fused_aa and x.ndim == 3:
            return aa_snake(x.contiguous(), alpha)
        if self.use_pallas and x.ndim == 3:
            return SnakeFn.apply(x.contiguous(), alpha)
        return x + (1.0 / (alpha + 1e-9)) * torch.sin(alpha * x) ** 2


class SnakeBeta(nn.Module):
    def __init__(self, channels: int, alpha_logscale: bool = True):
        super().__init__()
        self.channels = channels
        self.alpha_logscale = alpha_logscale
        self.alpha = _init(channels, alpha_logscale)
        self.beta = _init(channels, alpha_logscale)

    def forward(self, x: torch.Tensor, fused_aa: bool = False) -> torch.Tensor:
        alpha, beta = self.alpha, self.beta
        if self.alpha_logscale:
            alpha, beta = torch.exp(alpha), torch.exp(beta)
        if fused_aa and x.ndim == 3:
            return AASnakeBetaFn.apply(x.contiguous(), alpha, beta)
        return x + (1.0 / (beta + 1e-9)) * torch.sin(alpha * x) ** 2
