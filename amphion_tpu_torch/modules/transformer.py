"""Transformer blocks of the VITS text encoder (port of the VITS part of
`amphion_tpu/modules/transformer.py`): the sinusoid table, the key-mask
bias, multi-head attention with VITS's windowed relative positions, the
convolutional FFN and the post-LN encoder stack.

Layouts are JAX's (B, T, C); submodules carry the Flax scope names (``q``,
``k``, ``v``, ``out``, ``rel_k``, ``rel_v``; ``Conv_0``/``Conv_1``;
``MultiHeadAttention_i``, ``ConvFFN_i``, ``LayerNorm_j``), so
`utils/convert.from_flax` carries a JAX tree over. The relative-position
attention adds a bias that kernel 6 (key mask only) does not take, and the
JAX package computes it as einsums outside any Pallas kernel: it is plain
PyTorch here. Dropout is left out: the JAX trainers apply every model with
``deterministic=True``. `FFTBlock`, `TorchEncoderLayer` and `causal_bias`
are not ported (ROADMAP A6.6).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def conv_nlc(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A ``nn.Conv1d`` on a (B, T, C) tensor."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


def same_conv(c_in: int, c_out: int, kernel_size: int, dilation: int = 1, groups: int = 1,
              bias: bool = True) -> nn.Conv1d:
    """Flax ``Conv(c_out, (k,), kernel_dilation=(d,), padding="SAME")``."""
    return nn.Conv1d(c_in, c_out, kernel_size, dilation=dilation, groups=groups,
                     padding="same", bias=bias)


def sinusoidal_positions(length: int, dim: int, max_timescale: float = 1e4) -> np.ndarray:
    """Standard sin/cos positional table, (length, dim) float32."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(-np.arange(0, dim, 2, dtype=np.float64) / dim * np.log(max_timescale))
    tab = np.zeros((length, dim), np.float64)
    tab[:, 0::2] = np.sin(pos * div)
    tab[:, 1::2] = np.cos(pos * div[: (dim - dim // 2)])
    return tab.astype(np.float32)


def attention_bias_from_mask(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(B, T) padding mask → (B, 1, 1, T) additive bias: 0 on a kept key,
    the dtype's lowest value on a padded one."""
    low = torch.tensor(torch.finfo(dtype).min, dtype=dtype, device=mask.device)
    return torch.where(mask[:, None, None, :] != 0, torch.zeros((), dtype=dtype,
                                                                device=mask.device), low)


def _relative_to_absolute(rel: torch.Tensor, t: int) -> torch.Tensor:
    """(B, H, T, 2w+1) windowed relative logits → (B, H, T, T): entry (q, j)
    is rel[q, j − q + w] inside the window, 0 outside."""
    w = (rel.shape[-1] - 1) // 2
    idx = torch.arange(t, device=rel.device)
    k = idx[None, :] - idx[:, None] + w
    valid = (k >= 0) & (k <= 2 * w)
    k = k.clamp(0, 2 * w).expand(*rel.shape[:2], t, t)
    return torch.where(valid, torch.gather(rel, -1, k), torch.zeros((), dtype=rel.dtype,
                                                                     device=rel.device))


def _absolute_to_relative(abs_w: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, T, T) attention probabilities → (B, H, T, 2w+1) at relative
    offsets j − q in [−w, w] (0 outside the sequence)."""
    t = abs_w.shape[-1]
    padded = F.pad(abs_w, (w, w))
    idx = torch.arange(t, device=abs_w.device)[:, None] + torch.arange(2 * w + 1,
                                                                       device=abs_w.device)
    return torch.gather(padded, -1, idx.expand(*abs_w.shape[:2], t, 2 * w + 1))


class MultiHeadAttention(nn.Module):
    """Self- or cross-attention with optional windowed relative position
    keys and values (``rel_k``/``rel_v`` (2w+1, d), learned, shared by the
    heads), as VITS's encoder uses them."""

    def __init__(self, channels: int, num_heads: int, window_size: int | None = None):
        super().__init__()
        self.channels, self.num_heads, self.window_size = channels, num_heads, window_size
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.out = nn.Linear(channels, channels)
        if window_size is not None:
            d = channels // num_heads
            self.rel_k = nn.Parameter(torch.empty(2 * window_size + 1, d))
            self.rel_v = nn.Parameter(torch.empty(2 * window_size + 1, d))
            nn.init.normal_(self.rel_k, 0.0, d ** -0.5)
            nn.init.normal_(self.rel_v, 0.0, d ** -0.5)

    @torch.no_grad()
    def flax_init_(self, generator: torch.Generator) -> None:
        """The relative embeddings' Flax initializer, normal(d^-½)."""
        if self.window_size is not None:
            d = self.channels // self.num_heads
            self.rel_k.normal_(0.0, d ** -0.5, generator=generator)
            self.rel_v.normal_(0.0, d ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                bias: torch.Tensor | None = None) -> torch.Tensor:
        context = x if context is None else context
        h, d = self.num_heads, self.channels // self.num_heads

        def split(t):
            return t.reshape(*t.shape[:-1], h, d).transpose(1, 2)  # B, H, T, D

        q, k, v = split(self.q(x)), split(self.k(context)), split(self.v(context))
        scale = 1.0 / math.sqrt(d)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
        if self.window_size is not None:
            rel_logits = torch.einsum("bhqd,rd->bhqr", q, self.rel_k) * scale
            scores = scores + _relative_to_absolute(rel_logits, x.shape[1])
        if bias is not None:
            scores = scores + bias
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        if self.window_size is not None:
            rel_w = _absolute_to_relative(probs, self.window_size)
            out = out + torch.einsum("bhqr,rd->bhqd", rel_w, self.rel_v)
        out = out.transpose(1, 2).reshape(*x.shape[:-1], self.channels)
        return self.out(out)


class ConvFFN(nn.Module):
    """Position-wise FFN as two "SAME" 1-D convolutions, each input masked
    first so that padding cannot leak into kept frames through the kernel."""

    def __init__(self, channels: int, hidden: int, kernel_size: int = 3,
                 activation: str = "relu"):
        super().__init__()
        self.activation = activation
        self.Conv_0 = same_conv(channels, hidden, kernel_size)
        self.Conv_1 = same_conv(hidden, channels, kernel_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        m = 1.0 if mask is None else mask[..., None]
        h = conv_nlc(self.Conv_0, x * m)
        if self.activation == "gelu":
            h = h * torch.sigmoid(1.702 * h)  # the reference's sigmoid approximation
        else:
            h = torch.relu(h)
        return conv_nlc(self.Conv_1, h * m) * m


class TransformerEncoder(nn.Module):
    """VITS's post-LN encoder stack with relative attention: per layer
    ``LN(x + MHA(x))`` then ``LN(x + FFN(x))`` (LayerNorm eps 1e-5, torch's)."""

    def __init__(self, channels: int, num_heads: int, num_layers: int, ffn_hidden: int,
                 kernel_size: int = 3, window_size: int | None = 4):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"MultiHeadAttention_{i}",
                            MultiHeadAttention(channels, num_heads, window_size))
            self.add_module(f"LayerNorm_{2 * i}", nn.LayerNorm(channels, eps=1e-5))
            self.add_module(f"ConvFFN_{i}", ConvFFN(channels, ffn_hidden, kernel_size))
            self.add_module(f"LayerNorm_{2 * i + 1}", nn.LayerNorm(channels, eps=1e-5))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        bias = attention_bias_from_mask(mask, x.dtype) if mask is not None else None
        if mask is not None:
            x = x * mask[..., None]
        for i in range(self.num_layers):
            y = getattr(self, f"MultiHeadAttention_{i}")(x, bias=bias)
            x = getattr(self, f"LayerNorm_{2 * i}")(x + y)
            y = getattr(self, f"ConvFFN_{i}")(x, mask)
            x = getattr(self, f"LayerNorm_{2 * i + 1}")(x + y)
        if mask is not None:
            x = x * mask[..., None]
        return x
