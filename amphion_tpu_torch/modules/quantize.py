"""Vector quantizers for inference: nearest-code lookup and decode (port of
`amphion_tpu/modules/quantize.py` without the training losses and the
quantizer dropout).

`ResidualVQ.encode` walks the stages as the JAX ``__call__`` does at
inference: each stage quantizes what the stages before it left, and its
output (straight-through value ``z + (c - z)``, as JAX computes it) is taken
off the residual. Parameter names are the Flax ones (``q{i}``,
``in_proj``, ``out_proj``, ``codebook``).
"""

from __future__ import annotations

import torch
from torch import nn


def _nearest(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codebook indices by ``||c||^2 - 2 x.c`` (first index on ties).
    x (..., D), codebook (K, D) → (...) int64."""
    dots = torch.einsum("...d,kd->...k", x, codebook)
    c2 = (codebook ** 2).sum(dim=-1)
    dist = c2[None] - 2.0 * dots.reshape(-1, codebook.shape[0])
    return torch.argmin(dist, dim=-1).reshape(x.shape[:-1])


def _st(quantized: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The straight-through value ``x + (q - x)`` with JAX's roundings."""
    return x + (quantized - x)


class VectorQuantize(nn.Module):
    def __init__(self, codebook_size: int, codebook_dim: int):
        super().__init__()
        self.codebook = nn.Parameter(torch.randn(codebook_size, codebook_dim)
                                     / codebook_dim ** 0.5)

    def encode(self, x):
        return _nearest(x, self.codebook)

    def decode(self, idx):
        return self.codebook[idx]

    def quantize(self, x):
        """(quantized, indices) as the JAX ``__call__`` gives them."""
        idx = self.encode(x)
        return _st(self.decode(idx), x), idx


class FactorizedVectorQuantize(nn.Module):
    """Project to a low-dim code space, then look up the nearest code, by
    cosine distance when ``use_l2_normlize``; the quantized value is the raw
    codebook entry. ``out_proj`` (back to ``input_dim``) exists only with
    ``with_out_proj``: the Vevo tokenizers only encode."""

    def __init__(self, codebook_size: int, codebook_dim: int, input_dim: int,
                 use_l2_normlize: bool = True, with_out_proj: bool = False):
        super().__init__()
        self.use_l2_normlize = use_l2_normlize
        self.in_proj = nn.Linear(input_dim, codebook_dim)
        if with_out_proj:
            self.out_proj = nn.Linear(codebook_dim, input_dim)
        self.codebook = nn.Parameter(torch.randn(codebook_size, codebook_dim))

    def _lookup(self, z):
        cb = self.codebook
        if self.use_l2_normlize:
            z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)
            cb = cb / (torch.linalg.vector_norm(cb, dim=-1, keepdim=True) + 1e-8)
        return _nearest(z, cb)

    def encode(self, x):
        return self._lookup(self.in_proj(x))

    def decode(self, idx):
        return self.out_proj(self.codebook[idx])

    def quantize(self, x):
        """(quantized, indices) as the JAX ``__call__`` gives them."""
        z = self.in_proj(x)
        idx = self._lookup(z)
        return self.out_proj(_st(self.codebook[idx], z)), idx


class ResidualVQ(nn.Module):
    """Residual stack of ``num_quantizers`` VQ or factorized-VQ stages."""

    def __init__(self, num_quantizers: int, codebook_size: int, codebook_dim: int,
                 input_dim: int, quantizer_type: str = "fvq"):
        super().__init__()
        if quantizer_type not in ("fvq", "vq"):
            raise ValueError(f"quantizer_type {quantizer_type!r} is not fvq/vq")
        self.num_quantizers = num_quantizers
        for i in range(num_quantizers):
            q = (FactorizedVectorQuantize(codebook_size, codebook_dim, input_dim,
                                          with_out_proj=True)
                 if quantizer_type == "fvq" else VectorQuantize(codebook_size, codebook_dim))
            self.add_module(f"q{i}", q)

    def quantize(self, x):
        """x (B, T, D) → (quantized (B, T, D), indices (Q, B, T))."""
        residual, out, idx = x, torch.zeros_like(x), []
        for i in range(self.num_quantizers):
            zq, ids = getattr(self, f"q{i}").quantize(residual)
            out = out + zq
            residual = residual - zq
            idx.append(ids)
        return out, torch.stack(idx)

    def encode(self, x):
        """x (B, T, D) → codes (Q, B, T)."""
        return self.quantize(x)[1]

    def decode(self, indices):
        """codes (Q, B, T) → (B, T, D): the sum of every stage's decode."""
        out = None
        for i in range(self.num_quantizers):
            dec = getattr(self, f"q{i}").decode(indices[i])
            out = dec if out is None else out + dec
        return out
