"""Anti-aliased resampling around an activation (port of
`amphion_tpu/modules/anti_aliasing.py`; BigVGAN's AMP blocks).

Kaiser-windowed sinc low-pass filters around a nonlinearity: upsample 2x →
activation → downsample 2x. The filters are numpy constants; the filtering
is a depthwise ``conv_transpose1d`` / ``conv1d`` with edge padding, on the
JAX layout (B, T, C). `Activation1d` with ``use_pallas`` and a Snake or
SnakeBeta at ratios 2/2 hands the whole chain to the activation's fused
path (kernel 2, `ops/kernels/aa_snake.py`); the parameters are the same
either way, so one checkpoint loads into both.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass FIR (cutoff/half_width in cycles/sample)."""
    even = kernel_size % 2 == 0
    half = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half - 1) * np.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        t = np.arange(-half, half) + 0.5
    else:
        t = np.arange(kernel_size) - half
    f = 2 * cutoff * window * np.sinc(2 * cutoff * t)
    s = f.sum()
    if abs(s) > 1e-8:
        f = f / s
    return f.astype(np.float32)


def _kernel_size(ratio: int, kernel_size: int | None) -> int:
    return kernel_size or int(6 * ratio // 2) * 2


@functools.lru_cache(maxsize=8)
def up_filter(ratio: int = 2, kernel_size: int | None = None) -> np.ndarray:
    """The upsampler's FIR, gain ``ratio`` included."""
    k = _kernel_size(ratio, kernel_size)
    return kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, k) * ratio


@functools.lru_cache(maxsize=8)
def down_filter(ratio: int = 2, kernel_size: int | None = None) -> np.ndarray:
    """The decimator's FIR."""
    k = _kernel_size(ratio, kernel_size)
    return kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, k)


@functools.lru_cache(maxsize=32)
def _filter_tensor(up: bool, ratio: int, kernel_size: int | None, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    f = up_filter(ratio, kernel_size) if up else down_filter(ratio, kernel_size)
    return torch.from_numpy(f).to(device=device, dtype=dtype)[None, None]


def _depthwise(up: bool, ratio: int, kernel_size: int | None, x: torch.Tensor) -> torch.Tensor:
    """The filter as a (C, 1, k) depthwise weight for (B, C, T) ``x``, kept on
    x's device (no copy from the host per call)."""
    w = _filter_tensor(up, ratio, kernel_size, x.device, x.dtype)
    return w.expand(x.shape[1], 1, w.shape[-1])


def upsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: int | None = None) -> torch.Tensor:
    """Sinc-interpolated upsampling, (B, T, C) → (B, T*ratio, C)."""
    r = ratio
    f = up_filter(r, kernel_size)
    k = f.shape[0]
    pad = k // r - 1
    pad_left = pad * r + (k - r) // 2
    t_in = x.shape[1]
    xs = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate")
    # the filter is symmetric, so torch's transposed convolution (which
    # flips it) equals lax.conv_transpose's, which does not
    y = F.conv_transpose1d(xs, _depthwise(True, r, kernel_size, xs), stride=r,
                           groups=xs.shape[1])
    return y[:, :, pad_left: pad_left + t_in * r].transpose(1, 2)


def downsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: int | None = None) -> torch.Tensor:
    """Anti-aliased decimation, (B, T, C) → (B, T//ratio, C)."""
    r = ratio
    f = down_filter(r, kernel_size)
    k = f.shape[0]
    pad_left = (k - r) // 2
    pad_right = k - r - pad_left
    xs = F.pad(x.transpose(1, 2), (pad_left, pad_right), mode="replicate")
    y = F.conv1d(xs, _depthwise(False, r, kernel_size, xs), stride=r, groups=xs.shape[1])
    return y.transpose(1, 2)


class Activation1d:
    """up 2x → activation → down 2x (ref `act.py:14`).

    Not an ``nn.Module``: as in Flax, where the activation is built in the
    creating module's scope (``SnakeBeta_0`` beside ``Conv_0``) and this
    wrapper holds no parameters, the activation belongs to the module that
    creates it and this object only calls it. With ``use_pallas``, ratios
    2/2 and a Snake or SnakeBeta, the activation runs the fused chain
    itself (``fused_aa=True``: kernel 2 on the card)."""

    def __init__(self, activation, up_ratio: int = 2, down_ratio: int = 2,
                 use_pallas: bool = False):
        self.activation = activation
        self.up_ratio = up_ratio
        self.down_ratio = down_ratio
        self.use_pallas = use_pallas

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        from amphion_tpu_torch.modules.activations import Snake, SnakeBeta

        if (self.use_pallas and self.up_ratio == 2 and self.down_ratio == 2
                and isinstance(self.activation, (Snake, SnakeBeta))):
            return self.activation(x, fused_aa=True)
        x = upsample1d(x, self.up_ratio)
        x = self.activation(x)
        return downsample1d(x, self.down_ratio)
