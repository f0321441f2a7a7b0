"""Normalizing-flow blocks of the VITS family (port of
`amphion_tpu/modules/flows.py`): the gated WaveNet conditioner `WN`, the
mean-only affine coupling layer and its stack with flips, the dilated
depth-separable `DDSConv`, the piecewise rational-quadratic spline and its
coupling `ConvFlow`, `ElementwiseAffine` and `log_flow`.

Layouts are JAX's (B, T, C) and submodules carry the Flax scope names
(``in_i``/``res_skip_i``/``cond`` weight-normalised as Flax's
``WeightNorm`` does them, `modules/weight_norm.py`; ``pre``, ``enc``,
``post``, ``proj``, ``sep_i``, ``pw_i``, ``LayerNorm_j``, ``flow_i``).
The projections JAX starts at zero (``post``, ``proj``) are marked
``flax_zero_init`` for `utils/convert.init_like_flax`. The spline finds
each value's bin by counting the knots at or below it and gathers the
bin's parameters, as JAX does, so both directions are branch-free tensor
code; none of it is a Pallas kernel in JAX. Dropout is left out: the JAX
trainers run these with ``deterministic=True``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from amphion_tpu_torch.modules.transformer import conv_nlc, same_conv
from amphion_tpu_torch.modules.weight_norm import WNConv1d, WNLinear

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _mask3(x_mask: torch.Tensor | None):
    return 1.0 if x_mask is None else x_mask[..., None]


def _zero_conv(c_in: int, c_out: int) -> nn.Conv1d:
    conv = nn.Conv1d(c_in, c_out, 1)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    conv.flax_zero_init = True
    return conv


class WN(nn.Module):
    """Non-causal WaveNet: dilated "SAME" convolutions with gated tanh
    units, residual and skip paths, and optional global conditioning
    (``cond``, built when ``gin_channels`` is set)."""

    def __init__(self, hidden_channels: int, kernel_size: int = 5, dilation_rate: int = 1,
                 num_layers: int = 4, gin_channels: int = 0):
        super().__init__()
        self.hidden_channels, self.num_layers = hidden_channels, num_layers
        n = hidden_channels
        if gin_channels:
            self.cond = WNLinear(gin_channels, 2 * n * num_layers)
        for i in range(num_layers):
            self.add_module(f"in_{i}", WNConv1d(n, 2 * n, kernel_size, dilation_rate ** i))
            out_ch = 2 * n if i < num_layers - 1 else n
            self.add_module(f"res_skip_{i}", WNConv1d(n, out_ch, 1))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor | None = None,
                g: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, T, H); g (B, T, G) or (B, 1, G)."""
        output = torch.zeros_like(x)
        n = self.hidden_channels
        if g is not None:
            g_all = self.cond(g)
        for i in range(self.num_layers):
            x_in = getattr(self, f"in_{i}")(x)
            if g is not None:
                x_in = x_in + g_all[..., i * 2 * n: (i + 1) * 2 * n]
            a, b = x_in[..., :n], x_in[..., n:]
            acts = torch.tanh(a) * torch.sigmoid(b)
            res_skip = getattr(self, f"res_skip_{i}")(acts)
            if i < self.num_layers - 1:
                x = x + res_skip[..., :n]
                if x_mask is not None:
                    x = x * x_mask[..., None]
                output = output + res_skip[..., n:]
            else:
                output = output + res_skip
        if x_mask is not None:
            output = output * x_mask[..., None]
        return output


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling (as VITS uses it) with a WN conditioner:
    forward → (x, logdet (B,)), reverse → x."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int = 5,
                 dilation_rate: int = 1, num_layers: int = 4, gin_channels: int = 0,
                 mean_only: bool = True):
        super().__init__()
        self.half, self.mean_only = channels // 2, mean_only
        self.pre = nn.Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, num_layers, gin_channels)
        self.post = _zero_conv(hidden_channels, self.half if mean_only else channels)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor | None = None,
                g: torch.Tensor | None = None, reverse: bool = False):
        x0, x1 = x[..., : self.half], x[..., self.half:]
        h = conv_nlc(self.pre, x0)
        if x_mask is not None:
            h = h * x_mask[..., None]
        h = self.enc(h, x_mask, g=g)
        stats = conv_nlc(self.post, h)
        if self.mean_only:
            m, logs = stats, torch.zeros_like(stats)
        else:
            m, logs = stats[..., : self.half], stats[..., self.half:]
        mask = _mask3(x_mask)
        if not reverse:
            x1 = (m + x1 * torch.exp(logs)) * mask
            logdet = torch.sum(logs * mask, dim=(1, 2))
            return torch.cat([x0, x1], dim=-1), logdet
        x1 = (x1 - m) * torch.exp(-logs) * mask
        return torch.cat([x0, x1], dim=-1)


class ResidualCouplingBlock(nn.Module):
    """``n_flows`` coupling layers (``flow_i``), the channels flipped after
    each: forward → (x, Σ logdet), reverse → x."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int = 5,
                 dilation_rate: int = 1, num_layers: int = 4, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        self.n_flows = n_flows
        for i in range(n_flows):
            self.add_module(f"flow_{i}", ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate, num_layers,
                gin_channels))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor | None = None,
                g: torch.Tensor | None = None, reverse: bool = False):
        layers = [getattr(self, f"flow_{i}") for i in range(self.n_flows)]
        if not reverse:
            total = 0.0
            for layer in layers:
                x, ld = layer(x, x_mask, g=g)
                total = total + ld
                x = torch.flip(x, dims=(-1,))
            return x, total
        for layer in reversed(layers):
            x = torch.flip(x, dims=(-1,))
            x = layer(x, x_mask, g=g, reverse=True)
        return x


class DDSConv(nn.Module):
    """Dilated depth-separable convolutions (dilation k^i), each input
    masked first, LayerNorm (eps 1e-5) and exact GELU after both the
    depthwise and the pointwise convolution, with a residual."""

    def __init__(self, channels: int, kernel_size: int = 3, num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"sep_{i}", same_conv(channels, channels, kernel_size,
                                                  dilation=kernel_size ** i, groups=channels))
            self.add_module(f"LayerNorm_{2 * i}", nn.LayerNorm(channels, eps=1e-5))
            self.add_module(f"pw_{i}", nn.Conv1d(channels, channels, 1))
            self.add_module(f"LayerNorm_{2 * i + 1}", nn.LayerNorm(channels, eps=1e-5))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor | None = None,
                g: torch.Tensor | None = None) -> torch.Tensor:
        if g is not None:
            x = x + g
        m = _mask3(x_mask)
        for i in range(self.num_layers):
            y = conv_nlc(getattr(self, f"sep_{i}"), x * m)
            y = F.gelu(getattr(self, f"LayerNorm_{2 * i}")(y))
            y = conv_nlc(getattr(self, f"pw_{i}"), y)
            y = F.gelu(getattr(self, f"LayerNorm_{2 * i + 1}")(y))
            x = x + y
        return x * m


def _knots(unnormalized: torch.Tensor, min_size: float, tail_bound: float):
    """Softmax bin sizes floored at ``min_size`` → (knots (..., K+1) from
    −B to B, sizes (..., K))."""
    k = unnormalized.shape[-1]
    s = torch.softmax(unnormalized, dim=-1)
    s = min_size + (1 - min_size * k) * s
    cum = F.pad(torch.cumsum(s, dim=-1), (1, 0))
    cum = cum * 2 * tail_bound - tail_bound
    cum = torch.cat([cum[..., :-1], torch.full_like(cum[..., -1:], tail_bound)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(x: torch.Tensor, widths: torch.Tensor, heights: torch.Tensor,
                              derivs: torch.Tensor, inverse: bool = False,
                              tail_bound: float = 5.0,
                              min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
                              min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
                              min_derivative: float = DEFAULT_MIN_DERIVATIVE):
    """Element-wise monotonic rational-quadratic spline on [−B, B] with
    identity tails. x (...,); widths/heights (..., K) unnormalised; derivs
    (..., K−1) unnormalised inner derivatives (the boundary ones are 1).
    Returns (y, log|dy/dx|), both (...,)."""
    num_bins = widths.shape[-1]
    inside = (x >= -tail_bound) & (x <= tail_bound)
    cumw, w = _knots(widths, min_bin_width, tail_bound)
    cumh, h = _knots(heights, min_bin_height, tail_bound)
    d = min_derivative + F.softplus(derivs)
    d = F.pad(d, (1, 1), value=1.0)  # (..., K+1)

    xc = torch.clamp(x, -tail_bound, tail_bound)
    ref = cumh if inverse else cumw
    idx = torch.sum((xc[..., None] >= ref[..., :-1]).to(torch.int64), dim=-1) - 1
    idx = idx.clamp(0, num_bins - 1)[..., None]

    def take(a):
        return torch.gather(a, -1, idx)[..., 0]

    in_w, in_cumw = take(w), take(cumw[..., :-1])
    in_h, in_cumh = take(h), take(cumh[..., :-1])
    delta = in_h / in_w
    d_k, d_k1 = take(d[..., :-1]), take(d[..., 1:])

    if not inverse:
        theta = ((xc - in_cumw) / in_w).clamp(0.0, 1.0)
        num = in_h * (delta * theta ** 2 + d_k * theta * (1 - theta))
        den = delta + (d_k1 + d_k - 2 * delta) * theta * (1 - theta)
        y = in_cumh + num / den
        deriv_num = delta ** 2 * (d_k1 * theta ** 2 + 2 * delta * theta * (1 - theta)
                                  + d_k * (1 - theta) ** 2)
        logabsdet = torch.log(deriv_num + 1e-12) - 2 * torch.log(den + 1e-12)
    else:
        a = (xc - in_cumh) * (d_k1 + d_k - 2 * delta) + in_h * (delta - d_k)
        b_ = in_h * d_k - (xc - in_cumh) * (d_k1 + d_k - 2 * delta)
        c_ = -delta * (xc - in_cumh)
        disc = torch.clamp(b_ ** 2 - 4 * a * c_, min=0.0)
        root = (2 * c_ / (-b_ - torch.sqrt(disc) - 1e-12)).clamp(0.0, 1.0)
        y = root * in_w + in_cumw
        den = delta + (d_k1 + d_k - 2 * delta) * root * (1 - root)
        deriv_num = delta ** 2 * (d_k1 * root ** 2 + 2 * delta * root * (1 - root)
                                  + d_k * (1 - root) ** 2)
        logabsdet = -(torch.log(deriv_num + 1e-12) - 2 * torch.log(den + 1e-12))
    y = torch.where(inside, y, x)
    logabsdet = torch.where(inside, logabsdet, torch.zeros_like(logabsdet))
    return y, logabsdet


class ConvFlow(nn.Module):
    """Spline coupling conditioned by a DDSConv: forward → (x, logdet (B,)),
    reverse → x."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int = 3,
                 num_layers: int = 3, num_bins: int = 10, tail_bound: float = 5.0):
        super().__init__()
        self.half, self.num_bins, self.tail_bound = in_channels // 2, num_bins, tail_bound
        self.hidden_channels = hidden_channels
        self.pre = nn.Conv1d(self.half, hidden_channels, 1)
        self.convs = DDSConv(hidden_channels, kernel_size, num_layers)
        self.proj = _zero_conv(hidden_channels, self.half * (3 * num_bins - 1))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor | None = None,
                g: torch.Tensor | None = None, reverse: bool = False):
        x0, x1 = x[..., : self.half], x[..., self.half:]
        h = self.convs(conv_nlc(self.pre, x0), x_mask, g=g)
        h = conv_nlc(self.proj, h)
        b, t, _ = h.shape
        h = h.reshape(b, t, self.half, 3 * self.num_bins - 1)
        scale = 1.0 / math.sqrt(self.hidden_channels)
        nb = self.num_bins
        y1, logabsdet = rational_quadratic_spline(
            x1, h[..., :nb] * scale, h[..., nb: 2 * nb] * scale, h[..., 2 * nb:],
            inverse=reverse, tail_bound=self.tail_bound)
        mask = _mask3(x_mask)
        out = torch.cat([x0, y1], dim=-1) * mask
        if reverse:
            return out
        return out, torch.sum(logabsdet * mask, dim=(1, 2))


class ElementwiseAffine(nn.Module):
    """A learned per-channel affine flow (``m``, ``logs``, both 0 at init)."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels))
        self.logs = nn.Parameter(torch.zeros(channels))

    @torch.no_grad()
    def flax_init_(self, generator: torch.Generator) -> None:
        self.m.zero_()
        self.logs.zero_()

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor | None = None,
                reverse: bool = False):
        mask = _mask3(x_mask)
        if not reverse:
            y = (self.m + torch.exp(self.logs) * x) * mask
            logdet = torch.sum(self.logs * torch.ones_like(x) * mask, dim=(1, 2))
            return y, logdet
        return (x - self.m) * torch.exp(-self.logs) * mask


def log_flow(x: torch.Tensor, x_mask: torch.Tensor | None = None, reverse: bool = False,
             eps: float = 1e-5):
    """The log transform flow: forward → (log max(x, eps), logdet), reverse
    → exp(x), masked."""
    mask = _mask3(x_mask)
    if not reverse:
        y = torch.log(torch.clamp(x, min=eps)) * mask
        return y, torch.sum(-y, dim=(1, 2))
    return torch.exp(x) * mask
