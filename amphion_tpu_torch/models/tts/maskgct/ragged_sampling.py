"""Ragged batched MaskGCT sampling (port of
`amphion_tpu/models/tts/maskgct/ragged_sampling.py`): B requests with their
own prompt, phone and target lengths share one padded batch.

Each sample is packed ``[prompt_i | target_i | pad]`` (T2S:
``[phones_i | prompt_i | target_i | pad]``), so its rotary positions and
its key mask are those of a solo run; the re-mask count follows each
request's own schedule, ``floor(sin(t·π/2)·target_len_i)``; the CFG std
rescale takes each sample's statistics over its valid positions.

Randomness: every draw of a request comes from that request's own
``torch.Generator`` (one per request and stage, `maskgct_generators`), so
its tokens do not depend on the batch it is in. JAX's draws come from other
streams; the samplers take them from outside instead through ``gumbel``, an
iterator of (B, *shape) float32 arrays in the order JAX draws them (each
step: the (B, T, V) sampling noise, then the (B, T) re-mask noise; for the
S2A layer by layer), which the tests use to hold the port to JAX token for
token.

``compute_dtype`` casts the models' float32 parameters in place, as JAX
casts its parameter tree (its bf16 default); logits, softmax, sampling and
the CFG statistics stay float32.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np
import torch

from amphion_tpu_torch.models.tts.maskgct.maskgct import (
    MaskGCTS2A,
    MaskGCTT2S,
    _topk_filter_frac,
)
from amphion_tpu_torch.modules.llama import cast_params
from amphion_tpu_torch.ops.ragged import masked_std, pack_segments, unpack_target

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def maskgct_generators(seed: int, device) -> tuple[torch.Generator, torch.Generator]:
    """(T2S, S2A) generators of a request with ``seed``."""
    return (torch.Generator(device).manual_seed(2 * seed + 1),
            torch.Generator(device).manual_seed(2 * seed + 2))


def pack_prefix_target(prefix: torch.Tensor, target: torch.Tensor,
                       prefix_len: torch.Tensor) -> torch.Tensor:
    """Per-sample ``[prefix_i | target_i | pad]``: prefix (B, Lp, ...) and
    target (B, T, ...) right-padded, prefix_len (B,) → (B, Lp+T, ...)."""
    full_t = torch.full_like(prefix_len, target.shape[1])
    return pack_segments([prefix, target], [prefix_len, full_t])


def _gumbel(generators, shape: tuple[int, ...], device, draws: Iterator | None):
    """(B, *shape) Gumbel noise: the next of ``draws``, or one draw from
    each request's generator (uniform in [1e-10, 1), as JAX draws it)."""
    if draws is not None:
        g = torch.as_tensor(np.array(next(draws), np.float32), device=device)
        if tuple(g.shape) != (len(generators), *shape):
            raise ValueError(f"injected Gumbel draw {tuple(g.shape)}, want "
                             f"{(len(generators), *shape)}")
        return g
    u = torch.stack([torch.rand(shape, generator=gen, device=device) for gen in generators])
    return -torch.log(-torch.log(u + 1e-10))


def _step_times(n_steps: int) -> np.ndarray:
    return np.asarray([1.0 - i / n_steps for i in range(n_steps + 1)], np.float32)


def _remask_counts(t_next: np.float32, target_len: torch.Tensor) -> torch.Tensor:
    """floor(sin(t·π/2)·target_len) per sample, in float32 as JAX computes it."""
    s = torch.sin(torch.tensor(t_next, dtype=torch.float32) * np.float32(math.pi) / 2)
    return torch.floor(s.to(target_len.device) * target_len.float()).long()


def _mask_predict(logits, mask, generators, draws, temp, t_val, is_last):
    """One mask-predict update from float32 logits (B, T, V) → (sampled ids,
    re-mask scores): Gumbel-max sampling at temperature ``temp·t`` (greedy
    at the last step), then ``1 − p(sampled) + temp·t·Gumbel`` as the
    re-mask score of each still-masked position (−inf elsewhere)."""
    b, t_max, v = logits.shape
    dev = logits.device
    temp_i = max(np.float32(temp) * t_val, np.float32(1e-3))
    noise = _gumbel(generators, (t_max, v), dev, draws)
    sampled = torch.argmax(logits / temp_i + noise, dim=-1)
    if is_last:
        sampled = torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    conf = torch.gather(probs, -1, sampled[..., None])[..., 0]
    scores = (1.0 - conf) + (np.float32(temp) * t_val) * _gumbel(generators, (t_max,), dev, draws)
    return sampled, scores.masked_fill(~mask, float("-inf"))


def _remask(scores, mask, next_num):
    """The ``next_num`` (B,) highest scores of each row stay masked (ties by
    position, as JAX's stable argsort ranks them)."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return (rank < next_num[:, None]) & mask


def _cfg_rescale(embeds, un, tvalid, cfg_scale, rescale_cfg):
    """CFG with the per-sample std rescale over valid positions."""
    std_pos = masked_std(embeds, tvalid).to(embeds.dtype)
    g = embeds + cfg_scale * (embeds - un)
    g_rescaled = g * std_pos / torch.clamp(masked_std(g, tvalid).to(g.dtype), min=1e-6)
    return rescale_cfg * g_rescaled + (1 - rescale_cfg) * g


# -- T2S ---------------------------------------------------------------------------


def _t2s_step_ragged(mod: MaskGCTT2S, seq, mask, target_len, t, prompt_tokens,
                     prompt_len, phone_id, phone_len, cfg_scale, rescale_cfg):
    """One ragged reverse step → CFG'd logits in target space (B, T, V).

    The phone prefix, the prompt and the target are packed compactly per
    sample and the inner encoder is driven directly (the phone prefix's
    padding would otherwise shift every rotary position after it)."""
    b, t_max = seq.shape
    dev = seq.device
    tvalid = torch.arange(t_max, device=dev)[None, :] < target_len[:, None]
    tok_emb = torch.where(mask[..., None], mod.mask_emb[None, None, :], mod.cond_emb(seq))
    prompt_emb = mod.cond_emb(prompt_tokens)
    bb = mod.backbone
    phone_prefix = bb.cond_mlp(mod.phone_emb(phone_id))
    full = pack_segments([phone_prefix.to(tok_emb.dtype), prompt_emb, tok_emb],
                         [phone_len, prompt_len, target_len])
    pos = torch.arange(full.shape[1], device=dev)[None, :]
    x_mask = (pos < (phone_len + prompt_len + target_len)[:, None]).float()
    out = bb.encoder(full, cond=bb.step_cond(t, full.dtype), mask=x_mask)
    embeds = unpack_target(out, phone_len + prompt_len, t_max)
    # unconditional branch: no prompt, no phones
    un = mod.estimate(tok_emb, t, tvalid.float())
    return mod.to_logit(_cfg_rescale(embeds, un, tvalid, cfg_scale, rescale_cfg))


def _prepare(model, compute_dtype: str):
    if compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r} not in {sorted(DTYPES)}")
    dt = DTYPES[compute_dtype]
    if dt != torch.float32:
        cast_params(model, dt)
    return dt


@torch.inference_mode()
def t2s_sample_ragged(model: MaskGCTT2S, prompt_tokens, prompt_len, phone_id, phone_len,
                      target_len, generators, t_max: int, n_steps: int = 25,
                      temp: float = 0.9, filter_thres: float = 0.98, cfg: float = 1.0,
                      rescale_cfg: float = 0.75, compute_dtype: str = "bfloat16",
                      gumbel: Iterator | None = None) -> torch.Tensor:
    """Ragged batched text → semantic sampling → (B, t_max) int64, 0 past
    each target. prompt_tokens (B, Lp) and phone_id (B, Lph) right-padded,
    the lengths (B,); ``generators`` one `torch.Generator` per request on the
    model's device."""
    _prepare(model, compute_dtype)
    dev = prompt_tokens.device
    b = prompt_tokens.shape[0]
    t_list = _step_times(n_steps)
    target_len = target_len.to(dev)
    tvalid = torch.arange(t_max, device=dev)[None, :] < target_len[:, None]
    seq = torch.zeros((b, t_max), dtype=torch.long, device=dev)
    mask = tvalid
    for step in range(n_steps):
        t_val = t_list[step]
        t = torch.full((b,), float(t_val), device=dev)
        logits = _t2s_step_ragged(model, seq, mask, target_len, t, prompt_tokens,
                                  prompt_len, phone_id, phone_len, cfg, rescale_cfg).float()
        logits = _topk_filter_frac(logits, filter_thres)
        sampled, scores = _mask_predict(logits, mask, generators, gumbel, temp, t_val,
                                        step == n_steps - 1)
        seq = torch.where(mask, sampled, seq)
        mask = _remask(scores, mask, _remask_counts(t_list[step + 1], target_len))
        seq = seq.masked_fill(mask, 0)
    return seq.masked_fill(~tvalid, 0)


# -- S2A ---------------------------------------------------------------------------


def _s2a_step_ragged(mod: MaskGCTS2A, tokens_all, mask, target_len, layer, t,
                     semantic_packed, prompt_tokens_all, prompt_len, cfg_scale,
                     rescale_cfg=1.0):
    """One ragged S2A step on RVQ layer ``layer``, a host int for the whole
    batch or a (B,) tensor, a layer a row → logits (B, T, V).
    ``semantic_packed`` (B, Lp_max+T_max[, D]) is already in the packed
    ``[sem_prompt_i | sem_target_i | pad]`` layout (`pack_prefix_target`)."""
    c = mod.cfg
    b, _, t_max = tokens_all.shape
    lp_max = prompt_tokens_all.shape[2]
    dev = tokens_all.device
    rows = torch.full((b,), layer, device=dev) if isinstance(layer, int) else layer
    tvalid = torch.arange(t_max, device=dev)[None, :] < target_len[:, None]
    prompt_emb = torch.zeros((b, lp_max, c.hidden), dtype=mod.mask_emb.dtype, device=dev)
    for q in range(c.num_quantizers):
        prompt_emb = prompt_emb + getattr(mod, f"tok_emb_{q}")(prompt_tokens_all[:, q])
    cur = mod._xt(tokens_all, rows, mask, torch.zeros((b, t_max), dtype=torch.bool,
                                                       device=dev))
    x_emb = pack_prefix_target(prompt_emb, cur, prompt_len)
    cond = mod._cond_of(semantic_packed) + mod.layer_emb(rows)[:, None, :]
    pos = torch.arange(lp_max + t_max, device=dev)[None, :]
    am = (pos < (prompt_len + target_len)[:, None]).float()
    h = mod.backbone(x_emb, t, cond, mask=am)
    embeds_c = unpack_target(h, prompt_len, t_max)
    cond_t = unpack_target(cond, prompt_len, t_max)
    h_u = mod.backbone(cur, t, cond_t, mask=tvalid.float())
    return mod._layer_logits(_cfg_rescale(embeds_c, h_u, tvalid, cfg_scale, rescale_cfg),
                             layer)


@torch.inference_mode()
def s2a_sample_ragged(model: MaskGCTS2A, semantic_packed, prompt_tokens_all, prompt_len,
                      target_len, generators, t_max: int, first_layer_steps: int = 16,
                      rest_layer_steps: int = 1, temp: float = 1.0, cfg: float = 1.0,
                      compute_dtype: str = "bfloat16",
                      gumbel: Iterator | None = None) -> torch.Tensor:
    """Ragged batched semantic → acoustic sampling, layer by layer (iterative
    on layer 0, ``rest_layer_steps`` on the others) → (B, Q, t_max) int64,
    0 past each target. ``semantic_packed`` (B, Lp_max+t_max) token ids or
    (B, Lp_max+t_max, D) features; prompt_tokens_all (B, Q, Lp_max)."""
    dt = _prepare(model, compute_dtype)
    if semantic_packed.is_floating_point():
        semantic_packed = semantic_packed.to(dt)
    c = model.cfg
    dev = prompt_tokens_all.device
    b = prompt_tokens_all.shape[0]
    target_len = target_len.to(dev)
    tvalid = torch.arange(t_max, device=dev)[None, :] < target_len[:, None]
    tokens = torch.zeros((b, c.num_quantizers, t_max), dtype=torch.long, device=dev)
    for q in range(c.num_quantizers):
        n_steps = first_layer_steps if q == 0 else rest_layer_steps
        t_list = _step_times(n_steps)
        mask = tvalid
        for step in range(n_steps):
            t_val = t_list[step]
            t = torch.full((b,), float(t_val), device=dev)
            logits = _s2a_step_ragged(model, tokens, mask, target_len, q, t,
                                      semantic_packed, prompt_tokens_all, prompt_len,
                                      cfg).float()
            sampled, scores = _mask_predict(logits, mask, generators, gumbel, temp, t_val,
                                            step == n_steps - 1)
            cur = torch.where(mask, sampled, tokens[:, q])
            mask = _remask(scores, mask, _remask_counts(t_list[step + 1], target_len))
            tokens[:, q] = cur.masked_fill(mask, 0)
    return tokens.masked_fill(~tvalid[:, None, :], 0)
