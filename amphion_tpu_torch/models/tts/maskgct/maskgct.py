"""MaskGCT: masked generative codec transformer, inference modules (port of
`amphion_tpu/models/tts/maskgct/maskgct.py`).

Two stages: T2S (text → semantic tokens, `MaskGCTT2S`, a DiffLlamaPrefix
backbone with the phone embeddings as its prefix) and S2A (semantic →
acoustic RVQ codes, `MaskGCTS2A`, a DiffLlama backbone conditioned per
token). Both run iterative mask-predict through the ragged samplers of
`ragged_sampling.py`: the served batches, and one request
(`MaskGCTPipeline.__call__`) as a batch of one, where they give the tokens
of JAX's fixed-shape ``t2s_sample``/``s2a_sample``, which are not ported
on their own. The training losses are not ported.

Parameter names are the Flax scopes (``phone_emb``, ``cond_emb``,
``mask_emb``, ``tok_emb_{q}``, ``head_{q}``, ``layer_emb``, ``sem_proj``,
``backbone.cond_mlp.Dense_0``, ``to_logit``). Flax creates only the
parameters its init touched, so an S2A trained on the mel-proxy path
holds ``sem_proj`` and no ``cond_emb``: `MaskGCTS2A` takes which of the two
it holds as arguments, and `s2a_conditioning` reads them off a checkpoint's
keys, so the served path conditions as the checkpoint was trained.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from amphion_tpu_torch.modules.llama import (
    DiffLlamaEncoder,
    DiffLlamaPrefixEncoder,
    LlamaConfig,
)


def _topk_filter_frac(logits: torch.Tensor, thres: float) -> torch.Tensor:
    """Keep the top ceil((1-thres)·V) logits of each row, the rest -inf."""
    v = logits.shape[-1]
    k = max(1, int(math.ceil((1 - thres) * v)))
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def mask_prob_schedule(t: torch.Tensor) -> torch.Tensor:
    """sin(t·π/2) masking ratio."""
    return torch.sin(t * math.pi / 2.0)


def _llama(hidden: int, num_layers: int, num_heads: int, max_position: int) -> LlamaConfig:
    # the DiffLlama layers' FFN is 4·hidden, not the Llama 8/3 convention
    return LlamaConfig(hidden_size=hidden, num_layers=num_layers, num_heads=num_heads,
                       adaptive=True, intermediate_size=4 * hidden,
                       max_position=max_position)


@dataclass(frozen=True)
class T2SConfig:
    hidden: int = 1024
    num_layers: int = 16
    num_heads: int = 16
    codebook_size: int = 8192  # semantic vocab
    phone_vocab: int = 1024
    max_position: int = 8192

    def llama(self) -> LlamaConfig:
        return _llama(self.hidden, self.num_layers, self.num_heads, self.max_position)


@dataclass(frozen=True)
class S2AConfig:
    hidden: int = 1024
    num_layers: int = 16
    num_heads: int = 16
    codebook_size: int = 1024  # acoustic codebook size per RVQ layer
    num_quantizers: int = 12
    cond_codebook_size: int = 8192  # semantic vocab
    semantic_dim: int = 384  # dim of the continuous semantic features (proxy path)
    max_position: int = 8192

    def llama(self) -> LlamaConfig:
        return _llama(self.hidden, self.num_layers, self.num_heads, self.max_position)


class MaskGCTT2S(nn.Module):
    def __init__(self, cfg: T2SConfig):
        super().__init__()
        self.cfg = cfg
        self.phone_emb = nn.Embedding(cfg.phone_vocab, cfg.hidden)
        self.cond_emb = nn.Embedding(cfg.codebook_size, cfg.hidden)
        self.mask_emb = nn.Parameter(torch.randn(cfg.hidden) * 0.02)
        self.backbone = DiffLlamaPrefixEncoder(cfg.llama())
        self.to_logit = nn.Linear(cfg.hidden, cfg.codebook_size)

    def estimate(self, x_emb, t, x_mask, phone_emb=None, phone_mask=None):
        """The backbone over [phone prefix; token embeddings]."""
        return self.backbone(x_emb, t, x_mask, phone_emb, phone_mask)


def s2a_conditioning(keys) -> tuple[bool, bool]:
    """(holds ``cond_emb``, holds ``sem_proj``) from a checkpoint's keys: a
    state dict's dotted names or a Flax tree's top-level scopes."""
    keys = list(keys)

    def has(name):
        return any(k == name or k.startswith(name + ".") for k in keys)
    return has("cond_emb"), has("sem_proj")


class MaskGCTS2A(nn.Module):
    """Semantic → acoustic RVQ mask-predict model: per-layer token embeddings
    and heads, one shared mask embedding, a layer embedding added to the
    per-token conditioning, DiffLlama backbone.

    The conditioning is the embedded semantic tokens (``cond_emb``, when
    ``token_cond``) or projected continuous features (``sem_proj``, when
    ``feature_cond``, the mel-proxy path), chosen per call by the dtype of
    the ``semantic`` input (integer = token ids)."""

    def __init__(self, cfg: S2AConfig, token_cond: bool = True, feature_cond: bool = True):
        super().__init__()
        self.cfg = cfg
        for q in range(cfg.num_quantizers):
            self.add_module(f"tok_emb_{q}", nn.Embedding(cfg.codebook_size, cfg.hidden))
        self.mask_emb = nn.Parameter(torch.randn(cfg.hidden) * 0.02)
        if token_cond:
            self.cond_emb = nn.Embedding(cfg.cond_codebook_size, cfg.hidden)
        if feature_cond:
            self.sem_proj = nn.Linear(cfg.semantic_dim, cfg.hidden)
        self.layer_emb = nn.Embedding(cfg.num_quantizers, cfg.hidden)
        self.backbone = DiffLlamaEncoder(cfg.llama())
        for q in range(cfg.num_quantizers):
            self.add_module(f"head_{q}", nn.Linear(cfg.hidden, cfg.codebook_size))

    @property
    def token_cond(self) -> bool:
        return hasattr(self, "cond_emb")

    def _cond_of(self, semantic):
        """Semantic conditioning: token ids → cond_emb, floats → sem_proj."""
        if not semantic.is_floating_point():
            return self.cond_emb(semantic)
        return self.sem_proj(semantic)

    def _xt(self, tokens_all, layer, mask, is_prompt):
        """Input embedding sum: layers below ``layer`` contribute their real
        embeddings, the target layer mixes mask/real by ``mask``, layers above
        contribute real embeddings on the prompt and the mask token
        elsewhere. tokens_all (B, Q, T); layer (B,)."""
        mask_tok = self.mask_emb[None, None, :]
        x = torch.zeros((tokens_all.shape[0], tokens_all.shape[2], self.cfg.hidden),
                        dtype=self.mask_emb.dtype, device=tokens_all.device)
        for q in range(self.cfg.num_quantizers):
            emb_q = getattr(self, f"tok_emb_{q}")(tokens_all[:, q])
            below = (layer > q)[:, None, None].to(x.dtype)
            at = (layer == q)[:, None, None].to(x.dtype)
            above = (layer < q)[:, None, None].to(x.dtype)
            mixed_at = torch.where(mask[..., None], mask_tok, emb_q)
            mixed_above = torch.where(is_prompt[..., None], emb_q, mask_tok)
            x = x + below * emb_q + at * mixed_at + above * mixed_above
        return x

    def _layer_logits(self, h, layer):
        """Each row's logits from the head of its own RVQ layer. A host int
        (the samplers: one layer for the whole batch) picks that head; a (B,)
        tensor runs every head and picks per row, as JAX does, with no read
        on the host."""
        if isinstance(layer, int):
            return getattr(self, f"head_{layer}")(h)
        heads = torch.stack([getattr(self, f"head_{q}")(h)
                             for q in range(self.cfg.num_quantizers)], 1)
        return heads[torch.arange(h.shape[0], device=h.device), layer]
