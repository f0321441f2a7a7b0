"""Weight-normalised convolutions with Flax's rules (Flax ``nn.WeightNorm``
around ``nn.Conv`` / ``nn.ConvTranspose``, as BigVGAN builds them).

Flax normalises the kernel per output feature, ``v·rsqrt(Σv² + 1e-12)·scale``
with ``scale`` starting at 1, where ``torch.nn.utils.weight_norm``
normalises a ConvTranspose over its input channels and starts g at ‖v‖: so
the rule is written out here. Both modules take and return the JAX layout
(B, T, C). The Flax tree keeps the scale in a sibling scope
(``WeightNorm_k["Conv_j/kernel/scale"]``); `utils/convert.from_flax` finds
it there.

Flax's ``ConvTranspose`` (``transpose_kernel=False``) with BigVGAN's padding
``(k−1−p, k−1−(k−r−p))``, ``p = (k−r)//2``, is torch's ``conv_transpose1d``
with the kernel reversed along k (the bridge reverses it once), padding p
and the output cut to T·r samples (torch gives one more where k − r is
odd).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _normalized(v: torch.Tensor, scale: torch.Tensor, dims: tuple[int, ...],
                feature_dim: int) -> torch.Tensor:
    shape = [1] * v.ndim
    shape[feature_dim] = v.shape[feature_dim]
    w = v * torch.rsqrt((v * v).sum(dim=dims, keepdim=True) + 1e-12)
    return w * scale.reshape(shape)


class WNConv1d(nn.Module):
    """Flax ``WeightNorm(Conv(out, (k,), kernel_dilation=(d,), padding="SAME"))``.

    ``weight`` (out, in, k) is the unnormalised kernel, ``scale`` (out,)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.scale = nn.Parameter(torch.ones(out_channels))
        nn.init.normal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _normalized(self.weight, self.scale, (1, 2), 0)
        span = self.dilation * (self.weight.shape[-1] - 1)  # "SAME" at stride 1
        xs = F.pad(x.transpose(1, 2), (span // 2, span - span // 2))
        return F.conv1d(xs, w, self.bias, dilation=self.dilation).transpose(1, 2)


class WNConvTranspose1d(nn.Module):
    """Flax ``WeightNorm(ConvTranspose(out, (k,), strides=(r,), padding=
    ((k−1−p, k−1−(k−r−p)),)))``, p = (k − r)//2: (B, T, in) → (B, T·r, out).

    ``weight`` (in, out, k) is the unnormalised kernel in torch's layout,
    already reversed along k; ``scale`` (out,)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int):
        super().__init__()
        self.stride = stride
        self.padding = (kernel_size - stride) // 2
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.scale = nn.Parameter(torch.ones(out_channels))
        nn.init.normal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _normalized(self.weight, self.scale, (0, 2), 1)
        y = F.conv_transpose1d(x.transpose(1, 2), w, self.bias, stride=self.stride,
                               padding=self.padding)
        return y[:, :, : x.shape[1] * self.stride].transpose(1, 2)
