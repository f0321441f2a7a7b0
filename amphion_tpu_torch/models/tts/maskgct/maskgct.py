"""MaskGCT: masked generative codec transformer, inference modules (port of
`amphion_tpu/models/tts/maskgct/maskgct.py`).

Two stages: T2S (text → semantic tokens, `MaskGCTT2S`, a DiffLlamaPrefix
backbone with the phone embeddings as its prefix) and S2A (semantic →
acoustic RVQ codes, `MaskGCTS2A`, a DiffLlama backbone conditioned per
token). Both run iterative mask-predict through the ragged samplers of
`ragged_sampling.py`: the served batches, and one request
(`MaskGCTPipeline.__call__`) as a batch of one, where they give the tokens
of JAX's fixed-shape ``t2s_sample``/``s2a_sample``, which are not ported
on their own.

Training: `MaskGCTT2S.compute_loss` and `MaskGCTS2A.compute_loss` (JAX
l.109-145 and l.384-413), masked-token cross-entropy at a flow time ``t``
whose mask ratio is max(sin(tπ/2), 0.2), with a random prompt prefix of
[0, 0.4·T) positions (dropped with ``cond_drop_prob``, the phones too in
T2S), one masked position forced where a row has none, and, in S2A, one
RVQ layer a row. The draws (``t``, the mask's uniforms, ``prompt_len``,
``use_cond``, ``layer``) come from the caller or else from a
``torch.Generator``, so a test can feed JAX's. Flash attention runs with
the key mask in every layer, forward and backward (kernels 6 and 7).

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

from amphion_tpu_torch.models.tts.losses import masked_nll
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


def _llama(hidden: int, num_layers: int, num_heads: int, max_position: int,
           remat: bool = False) -> LlamaConfig:
    # the DiffLlama layers' FFN is 4·hidden, not the Llama 8/3 convention
    return LlamaConfig(hidden_size=hidden, num_layers=num_layers, num_heads=num_heads,
                       adaptive=True, intermediate_size=4 * hidden,
                       max_position=max_position, remat=remat)


def _masked_draws(b: int, t_len: int, cond_drop_prob: float, dev, generator, t=None,
                  mask_u=None, prompt_len=None, use_cond=None):
    """The masking draws of both losses, each given one kept, the others
    drawn from ``generator`` → (t (B,), mask (B, T) bool, is_prompt (B, T)
    bool, use_cond (B,) bool). ``prompt_len`` is the raw draw in
    [0, max(1, int(0.4·T))), zeroed where the condition is dropped."""
    def draw(x, shape):
        return (torch.rand(shape, generator=generator, device=dev) if x is None
                else torch.as_tensor(x, device=dev))
    t = torch.clamp(draw(t, (b,)).float(), 1e-5, 1.0)
    mp = torch.clamp(mask_prob_schedule(t), min=0.2)
    use_cond = (draw(None, (b,)) > cond_drop_prob if use_cond is None
                else torch.as_tensor(use_cond, device=dev).bool())
    if prompt_len is None:
        prompt_len = torch.randint(0, max(1, int(t_len * 0.4)), (b,), generator=generator,
                                   device=dev)
    prompt_len = torch.where(use_cond, torch.as_tensor(prompt_len, device=dev).long(), 0)
    pos = torch.arange(t_len, device=dev)[None, :]
    is_prompt = pos < prompt_len[:, None]
    mask = (draw(mask_u, (b, t_len)) < mp[:, None]) & ~is_prompt
    none_masked = ~mask.any(dim=1)
    mask = mask | (none_masked[:, None] & (pos == prompt_len[:, None]))
    return t, mask, is_prompt, use_cond



@dataclass(frozen=True)
class T2SConfig:
    hidden: int = 1024
    num_layers: int = 16
    num_heads: int = 16
    codebook_size: int = 8192  # semantic vocab
    phone_vocab: int = 1024
    cond_drop_prob: float = 0.2  # training: the prompt and phones dropped (CFG)
    max_position: int = 8192
    remat: bool = False

    def llama(self) -> LlamaConfig:
        return _llama(self.hidden, self.num_layers, self.num_heads, self.max_position,
                      self.remat)


@dataclass(frozen=True)
class S2AConfig:
    hidden: int = 1024
    num_layers: int = 16
    num_heads: int = 16
    codebook_size: int = 1024  # acoustic codebook size per RVQ layer
    num_quantizers: int = 12
    cond_codebook_size: int = 8192  # semantic vocab
    semantic_dim: int = 384  # dim of the continuous semantic features (proxy path)
    cond_drop_prob: float = 0.2  # training: the prompt dropped (CFG)
    max_position: int = 8192
    remat: bool = False

    def llama(self) -> LlamaConfig:
        return _llama(self.hidden, self.num_layers, self.num_heads, self.max_position,
                      self.remat)


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

    def compute_loss(self, x0, x_mask, phone_id, phone_mask, generator=None, t=None,
                     mask_u=None, prompt_len=None, use_cond=None):
        """Masked-token cross-entropy over semantic tokens x0 (B, T) →
        (loss, {"t2s_loss", "t2s_acc"}). A dropped row has no prompt and
        its phones masked out."""
        b, t_len = x0.shape
        t, mask, _, use_cond = _masked_draws(b, t_len, self.cfg.cond_drop_prob, x0.device,
                                             generator, t, mask_u, prompt_len, use_cond)
        x_emb = torch.where(mask[..., None], self.mask_emb[None, None, :], self.cond_emb(x0))
        phone_mask_eff = phone_mask * use_cond[:, None].to(phone_mask.dtype)
        logits = self.to_logit(self.estimate(x_emb, t, x_mask, self.phone_emb(phone_id),
                                             phone_mask_eff))
        w = mask.float() * x_mask
        loss = masked_nll(logits, x0, w)
        hit = (logits.detach().argmax(-1) == x0).float()
        acc = (hit * w).sum() / torch.clamp(w.sum(), min=1.0)
        return loss, {"t2s_loss": loss, "t2s_acc": acc}


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

    def compute_loss(self, tokens_all, x_mask, semantic, generator=None, t=None,
                     mask_u=None, prompt_len=None, use_cond=None, layer=None):
        """Masked-token cross-entropy on one RVQ layer a row, ``layer``
        (B,) in [0, Q): tokens_all (B, Q, T); semantic (B, T) ids or
        (B, T, D) features → (loss, {"s2a_loss"})."""
        b, _, t_len = tokens_all.shape
        dev = tokens_all.device
        if layer is None:
            layer = torch.randint(0, self.cfg.num_quantizers, (b,), generator=generator,
                                  device=dev)
        layer = torch.as_tensor(layer, device=dev).long()
        t, mask, is_prompt, _ = _masked_draws(b, t_len, self.cfg.cond_drop_prob, dev,
                                              generator, t, mask_u, prompt_len, use_cond)
        target = tokens_all.gather(1, layer[:, None, None].expand(-1, 1, t_len))[:, 0]
        x_emb = self._xt(tokens_all, layer, mask, is_prompt)
        cond = self._cond_of(semantic) + self.layer_emb(layer)[:, None, :]
        h = self.backbone(x_emb, t, cond, mask=x_mask)
        loss = masked_nll(self._layer_logits(h, layer), target, mask.float() * x_mask)
        return loss, {"s2a_loss": loss}

    def _layer_logits(self, h, layer):
        """Each row's logits from the head of its own RVQ layer. A host int
        (the samplers: one layer for the whole batch) picks that head; a (B,)
        tensor (the training loss) picks each row's head weights by a
        one-hot product, then runs one batched product: exact, no read on
        the host, no (B, Q, T, V) stack, and a backward free of atomics."""
        if isinstance(layer, int):
            return getattr(self, f"head_{layer}")(h)
        heads = [getattr(self, f"head_{q}") for q in range(self.cfg.num_quantizers)]
        pick = torch.nn.functional.one_hot(layer, len(heads)).to(h.dtype)  # (B, Q)
        w = torch.einsum("bq,qvd->bvd", pick, torch.stack([m.weight for m in heads]))
        bias = pick @ torch.stack([m.bias for m in heads])  # (B, V)
        return torch.baddbmm(bias[:, None, :], h, w.transpose(1, 2))
