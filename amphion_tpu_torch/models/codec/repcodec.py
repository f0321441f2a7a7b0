"""RepCodec tokenizer, ``"conv"`` style (port of
`amphion_tpu/models/codec/repcodec.py`): conv-residual encoder → factorized
VQ nearest-code lookup, and ``decode_tokens`` (tokens → the quantizer's
decoded latent, the MaskGCT S2A's conditioning on the mel-proxy path). The
conv decoder (``reconstruct_tokens``) is not ported. Features are (B, T, C)
as in JAX. ``with_decode`` gives the factorized quantizer its ``out_proj``,
which ``decode_tokens`` needs; the Vevo tokenizers only encode and have none.

Numerics kept from Flax: LayerNorm eps 1e-6, ``"SAME"`` convolution padding,
and the tanh approximation of GELU (the ``jax.nn.gelu`` default).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from amphion_tpu_torch.modules.quantize import FactorizedVectorQuantize, VectorQuantize


@dataclass(frozen=True)
class RepCodecConfig:
    feature_dim: int = 1024
    hidden: int = 384
    codebook_size: int = 8192
    codebook_dim: int = 8
    num_blocks: int = 4
    use_fvq: bool = True
    style: str = "conv"

    def __post_init__(self):
        if self.style != "conv":
            raise NotImplementedError(f"RepCodec style {self.style!r} is not ported")


class ConvBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(channels, eps=1e-6)
        self.Conv_0 = nn.Conv1d(channels, channels, 5, padding="same")
        self.Conv_1 = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        y = self.LayerNorm_0(x).transpose(1, 2)
        y = F.gelu(self.Conv_0(y), approximate="tanh")
        return x + self.Conv_1(y).transpose(1, 2)


class RepCodec(nn.Module):
    def __init__(self, cfg: RepCodecConfig, with_decode: bool = False):
        super().__init__()
        self.cfg = cfg
        self.in_proj = nn.Linear(cfg.feature_dim, cfg.hidden)
        for i in range(cfg.num_blocks):
            self.add_module(f"enc_{i}", ConvBlock(cfg.hidden))
        if cfg.use_fvq:
            self.quantizer = FactorizedVectorQuantize(
                cfg.codebook_size, cfg.codebook_dim, cfg.hidden, with_out_proj=with_decode)
        else:
            self.quantizer = VectorQuantize(cfg.codebook_size, cfg.hidden)

    @torch.inference_mode()
    def encode(self, feats: torch.Tensor) -> torch.Tensor:
        """feats (B, T, feature_dim) → tokens (B, T) int64."""
        h = self.in_proj(feats)
        for i in range(self.cfg.num_blocks):
            h = getattr(self, f"enc_{i}")(h)
        return self.quantizer.encode(h)

    @torch.inference_mode()
    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, T) → quantized latent (B, T, hidden)."""
        return self.quantizer.decode(tokens)
