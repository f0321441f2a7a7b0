"""Weight-normalised convolutions with Flax's rules (Flax ``nn.WeightNorm``
around ``nn.Conv`` / ``nn.ConvTranspose``, as BigVGAN builds them).

Flax normalises the kernel per output feature, ``v·rsqrt(Σv² + 1e-12)·scale``
with ``scale`` starting at 1, where ``torch.nn.utils.weight_norm``
normalises a ConvTranspose over its input channels and starts g at ‖v‖: so
the rule is written out here. Both modules take and return the JAX layout
(B, T, C). The Flax tree keeps the scale in a sibling scope
(``WeightNorm_k["Conv_j/kernel/scale"]``); `utils/convert.from_flax` finds
it there.

Flax's ``ConvTranspose`` (``transpose_kernel=False``) with padding
``(pl, pr)`` is torch's ``conv_transpose1d`` with the kernel reversed along
k (the bridge reverses it once), padding ``k−1−pl``, ``pr − pl`` more
samples on the right where ``pr > pl`` (``output_padding``), and the output
cut to Flax's length where ``pr < pl``. BigVGAN's padding is
``(k−1−p, k−1−(k−r−p))``, ``p = (k−r)//2`` (the default); the Amphion
codec's ``(k−1−⌈r/2⌉, k−1−⌊r/2⌋)`` with k = 2r is asymmetric for an odd r.

`WNConv1d` takes Flax's ``"SAME"`` padding at stride 1 (the default), or a
stride and an explicit ``(left, right)`` padding (the codec's strided
encoder convolutions, the MSD's grouped ones).

`WNLinear` is Flax ``WeightNorm(Dense(out))`` (the VITS WaveNet's global
conditioning, ``cond``), its kernel normalised over the inputs per output.

`WNConv2d` is the GAN discriminators' 2-D convolution (MPD, MRD, MS-STFT,
MS-SB-CQT), in torch's layout (B, C, H, W) in and out, with a symmetric
padding per axis and a dilation.
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
    """Flax ``WeightNorm(Conv(out, (k,), kernel_dilation=(d,), padding="SAME"))``,
    or with ``stride`` and ``padding=(left, right)``
    ``WeightNorm(Conv(out, (k,), strides=(stride,), padding=[padding],
    feature_group_count=groups))``.

    ``weight`` (out, in/groups, k) is the unnormalised kernel, ``scale``
    (out,)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, stride: int = 1,
                 padding: tuple[int, int] | None = None, groups: int = 1):
        super().__init__()
        self.dilation = dilation
        self.stride = stride
        self.groups = groups
        if padding is None:  # "SAME"; at stride 1 only
            if stride != 1:
                raise ValueError("WNConv1d: a strided convolution takes an explicit padding")
            span = dilation * (kernel_size - 1)
            padding = (span // 2, span - span // 2)
        self.padding = tuple(padding)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.scale = nn.Parameter(torch.ones(out_channels))
        nn.init.normal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _normalized(self.weight, self.scale, (1, 2), 0)
        xs = F.pad(x.transpose(1, 2), self.padding)
        return F.conv1d(xs, w, self.bias, stride=self.stride, dilation=self.dilation,
                        groups=self.groups).transpose(1, 2)


class WNLinear(nn.Module):
    """Flax ``WeightNorm(Dense(out))``: ``weight`` (out, in) is the
    unnormalised kernel (torch's layout), ``scale`` (out,)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.scale = nn.Parameter(torch.ones(out_features))
        nn.init.normal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, _normalized(self.weight, self.scale, (1,), 0), self.bias)


class WNConv2d(nn.Module):
    """Flax ``WeightNorm(Conv(out, (kh, kw), strides=stride, padding=((ph,
    ph), (pw, pw)), kernel_dilation=dilation))`` on (B, C, H, W) tensors.

    ``weight`` (out, in, kh, kw) is the unnormalised kernel, ``scale``
    (out,)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: tuple[int, int],
                 stride: tuple[int, int] = (1, 1), padding: tuple[int, int] = (0, 0),
                 dilation: tuple[int, int] = (1, 1)):
        super().__init__()
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.dilation = tuple(dilation)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.scale = nn.Parameter(torch.ones(out_channels))
        nn.init.normal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _normalized(self.weight, self.scale, (1, 2, 3), 0)
        return F.conv2d(x, w, self.bias, stride=self.stride, padding=self.padding,
                        dilation=self.dilation)


class WNConvTranspose1d(nn.Module):
    """Flax ``WeightNorm(ConvTranspose(out, (k,), strides=(r,), padding=
    ((pl, pr),)))``: (B, T, in) → (B, (T−1)·r + pl + pr − k + 2, out).
    ``padding`` defaults to BigVGAN's ``(k−1−p, k−1−(k−r−p))``,
    p = (k − r)//2, whose output is T·r long.

    ``weight`` (in, out, k) is the unnormalised kernel in torch's layout,
    already reversed along k; ``scale`` (out,)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 padding: tuple[int, int] | None = None):
        super().__init__()
        k = kernel_size
        if padding is None:
            p = (k - stride) // 2
            padding = (k - 1 - p, k - 1 - (k - stride - p))
        pl, pr = padding
        if not 0 <= pl <= k - 1 or pr < 0:
            raise ValueError(f"WNConvTranspose1d: padding {padding} out of range for k={k}")
        self.stride = stride
        self.padding = k - 1 - pl
        self.output_padding = max(pr - pl, 0)
        if self.output_padding >= stride:
            raise ValueError(f"WNConvTranspose1d: padding {padding} extends the right by "
                             f"{self.output_padding} >= stride {stride}")
        self.extent = pl + pr - k + 2  # output length (T - 1)·r + extent
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.scale = nn.Parameter(torch.ones(out_channels))
        nn.init.normal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _normalized(self.weight, self.scale, (0, 2), 1)
        y = F.conv_transpose1d(x.transpose(1, 2), w, self.bias, stride=self.stride,
                               padding=self.padding, output_padding=self.output_padding)
        return y[:, :, : (x.shape[1] - 1) * self.stride + self.extent].transpose(1, 2)
