"""VALL-E zero-shot TTS, inference (port of
`amphion_tpu/models/tts/valle/valle.py`): an AR decoder continues
codebook 0 of the codec after ``[phones; prompt codes]``, then a NAR
encoder fills codebooks 1..Q-1 stage by stage, greedily, conditioned on the
sum of the lower codebooks' embeddings and a stage embedding (its adaptive
norms), with the prompt's full codes as an acoustic prefix.

Both stages are the port's Llama backbone (`modules/llama.py`): the AR a
`LlamaDecoder` with a KV cache, the NAR an adaptive `LlamaEncoder` with the
key mask (kernel 6 in every layer on the card). Submodules carry the Flax
scope names (``phone_embed``, ``audio_embed_{q}``, ``ar``, ``nar``,
``stage_embed``, ``ar_head``, ``nar_head``), so `utils/convert.from_flax`
loads a JAX `VALLE` tree unchanged.

Training (`train_loss`, JAX l.92-189) computes both stages' losses from
one batch: the AR's teacher-forced cross-entropy on codebook 0 over
``[phones; codes]`` (causal flash attention with the key mask, kernels 6
and 7 in every layer; padded phones leave holes between the real phones
and the codes), EOS scored at each row's length, and the NAR's on one
stage a row, drawn in [1, Q), with a random acoustic prefix (``prefix_mode``
1: ``plen`` in [low, 2·low), low = 0.25 of the batch's shortest row,
capped at ``max_prefix_len``) that sums every codebook and is not scored.
The draws (``stage``, ``plen``) come from the caller or else from a
``torch.Generator``, so a test can feed JAX's.

Generation follows the JAX functions: the decode loop runs ``max_new``
steps with the EOS freeze on the device (`ar_transformer.decode_loop`);
the ragged forms pack each request right-aligned (AR) or compactly (NAR,
`ops/ragged.py`) so its rotary positions are those of a solo run. Each
request draws from its own ``torch.Generator`` (one for the batch in the
fixed-shape `ar_generate`); temperature 0 takes the argmax.

Decode preparation (`prepare_for_decode`, JAX `_prep_decode`): float32 and
bf16 cast the parameters; int8/int4 cast them to bf16 and quantize the AR's
projections only (the NAR runs bf16, as JAX maps int8/int4 to bf16 there),
with the int8 KV cache unless ``AMPHION_KV_QUANT=0``. In the quantized
decode ``ar_head`` runs through the row-invariant bf16 GEMV
(`ops/kernels/bf16_gemv`), its bias added after, so that a row's logits do
not depend on the other rows of its batch.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import torch
from torch import nn

from amphion_tpu_torch.models.tts.losses import masked_nll
from amphion_tpu_torch.models.vc.ar_transformer import (
    DECODE_DTYPES,
    check_decode_dtype,
    decode_loop,
)
from amphion_tpu_torch.modules.llama import (
    LlamaConfig,
    LlamaDecoder,
    LlamaEncoder,
    cast_params,
    quantize_llama_params,
    validate_quantized_tree,
)
from amphion_tpu_torch.ops.kernels.bf16_gemv import bf16_linear
from amphion_tpu_torch.ops.ragged import (
    pack_segments,
    pack_segments_right,
    right_pack_valid,
    unpack_target,
)


@dataclass(frozen=True)
class VALLEConfig:
    num_phones: int = 512
    audio_vocab: int = 1024  # codec codebook size
    num_quantizers: int = 8
    hidden: int = 1024
    num_layers: int = 12
    num_heads: int = 16
    max_position: int = 4096
    decode_quant: str = "none"  # the AR's projections: "none" | "int8" | "int4"
    kv_quant: bool = False  # the AR's int8 KV cache
    remat: bool = False  # recompute each block's activations in the backward
    # the NAR's acoustic prefix in training: 0 none, 1 a random prefix of each
    # row that sums every codebook and is not scored (the recipes' mode)
    prefix_mode: int = 1
    max_prefix_len: int = 225

    @property
    def eos_id(self) -> int:
        return self.audio_vocab  # the extra symbol of codebook 0's vocabulary

    def llama(self, adaptive: bool = False) -> LlamaConfig:
        return LlamaConfig(
            hidden_size=self.hidden, num_layers=self.num_layers, num_heads=self.num_heads,
            max_position=self.max_position, adaptive=adaptive, remat=self.remat,
            decode_quant="none" if adaptive else self.decode_quant,
            kv_quant=False if adaptive else self.kv_quant)


class VALLE(nn.Module):
    def __init__(self, cfg: VALLEConfig):
        super().__init__()
        self.cfg = cfg
        self.phone_embed = nn.Embedding(cfg.num_phones, cfg.hidden)
        for q in range(cfg.num_quantizers):  # codebook 0 has the EOS slot
            self.add_module(f"audio_embed_{q}",
                            nn.Embedding(cfg.audio_vocab + (q == 0), cfg.hidden))
        self.ar = LlamaDecoder(cfg.llama(False))
        self.nar = LlamaEncoder(cfg.llama(True))
        self.stage_embed = nn.Embedding(cfg.num_quantizers - 1, cfg.hidden)
        self.ar_head = nn.Linear(cfg.hidden, cfg.audio_vocab + 1)
        self.nar_head = nn.Linear(cfg.hidden, cfg.audio_vocab)

    # -- the decode interface the continuous engine drives ----------------------
    @property
    def device(self) -> torch.device:
        return self.phone_embed.weight.device

    @property
    def decoder(self) -> LlamaDecoder:
        return self.ar

    @property
    def decode_vocab(self) -> int:
        return self.cfg.audio_vocab + 1

    def audio_embed(self, q: int) -> nn.Embedding:
        return getattr(self, f"audio_embed_{q}")

    def head(self, h):
        """``ar_head``; in the quantized decode the row-invariant bf16 GEMV
        and the bias (the head's weights are bf16 there)."""
        if self.cfg.decode_quant != "none":
            return bf16_linear(h, self.ar_head.weight) + self.ar_head.bias
        return self.ar_head(h)

    # -- AR stage ---------------------------------------------------------------
    def ar_forward(self, phones, phone_mask, tokens, token_mask):
        """Teacher-forced AR logits (B, T+1, V+1) over ``[phones; tokens]``
        (tokens (B, T), codebook 0): the last phone position predicts token 0,
        token t predicts token t+1, the last predicts EOS."""
        x = torch.cat([self.phone_embed(phones), self.audio_embed(0)(tokens)], dim=1)
        h = self.ar(x, mask=torch.cat([phone_mask, token_mask], dim=1))
        return self.ar_head(h[:, phones.shape[1] - 1:])

    def ar_loss(self, phones, phone_mask, tokens, token_mask):
        """Cross-entropy of every real token and of the EOS right after the
        last one (index ``length`` of the T+1 axis)."""
        logits = self.ar_forward(phones, phone_mask, tokens, token_mask)
        targets = torch.cat([tokens, torch.full_like(tokens[:, :1], self.cfg.eos_id)], dim=1)
        w = torch.cat([token_mask, torch.zeros_like(token_mask[:, :1])], dim=1)
        lengths = token_mask.sum(dim=1).long()
        w = w.scatter(1, lengths[:, None], 1.0)
        return masked_nll(logits, targets, w)

    def ar_prefill(self, phones, prompt_tokens, caches):
        """[phones; prompt] written at cache position 0 → (last logits, caches)."""
        x = torch.cat([self.phone_embed(phones), self.audio_embed(0)(prompt_tokens)], dim=1)
        h, caches = self.ar.forward_cached(x, caches, 0)
        return self.head(h[:, -1]), caches

    def ar_prefill_ragged(self, phones, phone_len, prompt_tokens, prompt_len, caches,
                          kv_valid):
        """Ragged prefill: per-sample ``[pad | phones_i | prompt_i]`` packed
        right-aligned, the pad slots masked by ``kv_valid`` → (last logits,
        caches)."""
        x = pack_segments_right(
            [self.phone_embed(phones), self.audio_embed(0)(prompt_tokens)],
            [phone_len, prompt_len])
        h, caches = self.ar.forward_cached(x, caches, 0, kv_valid)
        return self.head(h[:, -1]), caches

    def ar_step(self, token, caches, cache_index, kv_valid=None):
        """One token a row at ``cache_index`` (an int, or each row's (B,)
        position) → (logits (B, V+1), caches)."""
        h, caches = self.ar.forward_cached(self.audio_embed(0)(token)[:, None, :], caches,
                                           cache_index, kv_valid)
        return self.head(h[:, -1]), caches

    step = ar_step

    def make_cache(self, batch: int, total_len: int, dtype=torch.float32):
        return self.ar.init_cache(batch, total_len, dtype, self.device)

    # -- NAR stage --------------------------------------------------------------
    def _audio_sum(self, tokens_all, stage, prompt_mask):
        """Sum of the embeddings of codebooks below ``stage`` (B,), and of
        every codebook where ``prompt_mask`` (B, T) is set."""
        acc = self.audio_embed(0)(tokens_all[:, 0])
        for q in range(1, self.cfg.num_quantizers):
            take = (stage > q)[:, None].expand(tokens_all.shape[0], tokens_all.shape[2])
            if prompt_mask is not None:
                take = take | (prompt_mask > 0)
            acc = acc + torch.where(take[..., None], self.audio_embed(q)(tokens_all[:, q]),
                                    0.0)
        return acc

    def nar_forward(self, phones, phone_mask, tokens_all, token_mask, stage,
                    prompt_mask=None):
        """NAR logits (B, T, V) for codebook ``stage`` (B,) in [1, Q):
        tokens_all (B, Q, T); where ``prompt_mask`` (B, T) is 1 the position is
        an acoustic prompt and sums every codebook."""
        x = torch.cat([self.phone_embed(phones),
                       self._audio_sum(tokens_all, stage, prompt_mask)], dim=1)
        mask = torch.cat([phone_mask, token_mask], dim=1)
        h = self.nar(x, cond=self.stage_embed(stage - 1), mask=mask)
        return self.nar_head(h[:, phones.shape[1]:])

    def nar_loss(self, phones, phone_mask, tokens_all, token_mask, stage, prompt_mask=None):
        """Cross-entropy of codebook ``stage`` at the real positions outside
        the prompt."""
        logits = self.nar_forward(phones, phone_mask, tokens_all, token_mask, stage,
                                  prompt_mask)
        idx = stage.long()[:, None, None].expand(-1, 1, tokens_all.shape[2])
        targets = tokens_all.gather(1, idx)
        w = token_mask if prompt_mask is None else token_mask * (1.0 - prompt_mask)
        return masked_nll(logits, targets[:, 0], w)

    def train_draws(self, token_mask, generator=None, stage=None, plen=None):
        """The NAR's draws → (stage (B,) in [1, Q), prompt mask (B, T) or
        None): each given one is kept, the others drawn from ``generator``
        on the device, with no read on the host."""
        c = self.cfg
        b, dev = token_mask.shape[0], token_mask.device
        if stage is None:
            stage = torch.randint(1, c.num_quantizers, (b,), generator=generator, device=dev)
        stage = stage.to(dev, torch.long)
        if c.prefix_mode != 1:
            return stage, None
        if plen is None:  # U[low, low + max(low, 1)), low = 0.25 of the shortest row
            low = torch.floor(0.25 * token_mask.sum(dim=1).min())
            u = torch.rand((), generator=generator, device=dev)
            plen = low + torch.floor(u * torch.clamp(low, min=1.0))
        plen = torch.clamp(torch.as_tensor(plen, device=dev), max=c.max_prefix_len)
        pos = torch.arange(token_mask.shape[1], device=dev)[None, :]
        return stage, (pos < plen).to(token_mask.dtype) * token_mask

    def train_loss(self, phones, phone_mask, tokens_all, token_mask, generator=None,
                   stage=None, plen=None):
        """The joint objective: the AR's loss on codebook 0 plus the NAR's
        on a drawn stage → (loss, {"ar_loss", "nar_loss"})."""
        ar = self.ar_loss(phones, phone_mask, tokens_all[:, 0], token_mask)
        stage, prompt_mask = self.train_draws(token_mask, generator, stage, plen)
        nar = self.nar_loss(phones, phone_mask, tokens_all, token_mask, stage, prompt_mask)
        return ar + nar, {"ar_loss": ar, "nar_loss": nar}

    def nar_generate(self, phones, phone_mask, tokens0, token_mask, prompt_tokens=None):
        """Greedy NAR decoding of codebooks 1..Q-1 given codebook 0 (B, T);
        ``prompt_tokens`` (B, Q, Tp), the prompt's full codes, prepended as
        an acoustic prefix → codes of the target region (B, Q, T)."""
        c = self.cfg
        b, t = tokens0.shape
        tgt = torch.zeros((b, c.num_quantizers, t), dtype=torch.long, device=tokens0.device)
        tgt[:, 0] = tokens0
        if prompt_tokens is None:
            all_tokens, full_mask, prompt_mask, tp = tgt, token_mask, None, 0
        else:
            tp = prompt_tokens.shape[2]
            all_tokens = torch.cat([prompt_tokens.long(), tgt], dim=2)
            ones = torch.ones((b, tp), dtype=token_mask.dtype, device=token_mask.device)
            full_mask = torch.cat([ones, token_mask], dim=1)
            prompt_mask = torch.cat([ones, torch.zeros_like(token_mask)], dim=1)
        for q in range(1, c.num_quantizers):
            stage = torch.full((b,), q, dtype=torch.long, device=tokens0.device)
            pred = self.nar_forward(phones, phone_mask, all_tokens, full_mask, stage,
                                    prompt_mask).argmax(-1)
            if prompt_mask is not None:
                pred = torch.where(prompt_mask > 0, all_tokens[:, q], pred)
            all_tokens[:, q] = pred
        return all_tokens[:, :, tp:]


def _nar_generate_ragged(mod: VALLE, phones, phone_len, tokens0, target_len,
                         prompt_tokens_all, prompt_len):
    """Ragged `VALLE.nar_generate` in the compact layout ``[phones_i |
    prompt_i | target_i | pad]``, greedy per stage → (B, Q, T_max) codes of
    the target region, 0 past each length."""
    c = mod.cfg
    b, t_max = tokens0.shape
    dev = tokens0.device
    tp_max = prompt_tokens_all.shape[2]
    ttot = tp_max + t_max
    full_t = torch.full((b,), t_max, dtype=torch.long, device=dev)
    tgt_all = torch.zeros((b, c.num_quantizers, t_max), dtype=torch.long, device=dev)
    tgt_all[:, 0] = tokens0
    # pack the audio stream (prompt ++ target) per sample, Q as the feature dim
    all_tokens = pack_segments([prompt_tokens_all.long().transpose(1, 2),
                                tgt_all.transpose(1, 2)],
                               [prompt_len, full_t]).transpose(1, 2).contiguous()
    pos = torch.arange(ttot, device=dev)[None, :]
    prompt_mask = (pos < prompt_len[:, None]).float()
    pe = mod.phone_embed(phones)
    n_all = phone_len + prompt_len + target_len
    for q in range(1, c.num_quantizers):
        stage = torch.full((b,), q, dtype=torch.long, device=dev)
        x = pack_segments([pe, mod._audio_sum(all_tokens, stage, prompt_mask)],
                          [phone_len, prompt_len + target_len])
        mask = (torch.arange(x.shape[1], device=dev)[None, :] < n_all[:, None]).float()
        h = mod.nar(x, cond=mod.stage_embed(stage - 1), mask=mask)
        pred = mod.nar_head(unpack_target(h, phone_len, ttot)).argmax(-1)
        all_tokens[:, q] = torch.where(prompt_mask > 0, all_tokens[:, q], pred)
    target = unpack_target(all_tokens.transpose(1, 2), prompt_len, t_max).transpose(1, 2)
    tvalid = torch.arange(t_max, device=dev)[None, None, :] < target_len[:, None, None]
    return torch.where(tvalid, target, 0)


# -- decode preparation and generation ------------------------------------------------


def prepare_for_decode(model: VALLE, compute_dtype: str) -> VALLE:
    """The model a decode in ``compute_dtype`` runs, AR and NAR: float32/bf16
    cast the parameters in place; int8/int4 build a model whose AR holds
    quantized projections (from the bf16-cast weights, scales float32), and,
    unless ``AMPHION_KV_QUANT=0``, the int8 KV cache, every other weight
    bf16. A model already prepared for ``compute_dtype`` is returned as it is.
    Call once, when the service is built."""
    if compute_dtype not in DECODE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r} not in {tuple(DECODE_DTYPES)}")
    quant = compute_dtype if compute_dtype in ("int8", "int4") else "none"
    if model.cfg.decode_quant != "none":
        if model.cfg.decode_quant != quant:
            raise ValueError(f"the model holds {model.cfg.decode_quant} projections; "
                             f"prepare the float model for {compute_dtype}")
        return model
    if quant == "none":
        return cast_params(model, DECODE_DTYPES[compute_dtype]).eval()
    qcfg = dataclasses.replace(model.cfg, decode_quant=quant,
                               kv_quant=os.environ.get("AMPHION_KV_QUANT", "1") != "0")
    with torch.device(model.device):
        qmodel = VALLE(qcfg)
    with torch.no_grad():
        state = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                 for k, v in model.state_dict().items()}
        ar = quantize_llama_params({k[3:]: v for k, v in state.items() if k.startswith("ar.")},
                                   quant)
        validate_quantized_tree(ar, qcfg.llama(False))
        state = {**{k: v for k, v in state.items() if not k.startswith("ar.")},
                 **{f"ar.{k}": v for k, v in ar.items()}}
        cast_params(qmodel, torch.bfloat16).load_state_dict(state)
    return qmodel.eval()


def _nar_dtype(model: VALLE, compute_dtype: str) -> None:
    dt = DECODE_DTYPES[compute_dtype]  # int8/int4 → the NAR in bf16
    if model.nar_head.weight.dtype != dt:
        raise ValueError(f"the NAR holds {model.nar_head.weight.dtype} weights but "
                         f"compute_dtype is {compute_dtype}: prepare the model once "
                         "with prepare_for_decode")


@torch.inference_mode()
def ar_generate(model: VALLE, phones, prompt_tokens, generator=None, max_new: int = 512,
                temperature: float = 1.0, top_k: int = 50,
                compute_dtype: str = "bfloat16"):
    """AR continuation of codebook 0 after [phones; prompt] for a (B, L)
    batch of equal lengths, one ``generator`` for the batch → (tokens
    (B, max_new), 0 from a row's EOS on; lengths (B,))."""
    dt = check_decode_dtype(model, compute_dtype)
    dev = model.device
    phones, prompt_tokens = phones.to(dev), prompt_tokens.to(dev)
    b, lp = phones.shape
    l0 = lp + prompt_tokens.shape[1]
    caches = model.make_cache(b, l0 + max_new, dt)
    logits, caches = model.ar_prefill(phones, prompt_tokens, caches)
    return decode_loop(model, caches, logits, l0, max_new, generator, temperature, top_k,
                        1.0)


@torch.inference_mode()
def ar_generate_ragged(model: VALLE, phones, phone_len, prompt_tokens, prompt_len,
                       generators=None, max_new: int = 512, temperature: float = 1.0,
                       top_k: int = 50, compute_dtype: str = "bfloat16",
                       capacity: int | None = None):
    """Ragged batched AR decode: right-padded phones (B, Lph) and prompt
    codebook-0 tokens (B, Lt) with their (B,) lengths, one generator per
    request → (tokens (B, max_new), lengths (B,)). ``capacity`` widens the
    KV cache to the continuous engine's (on the card a request's logits
    depend on the cache's length)."""
    dt = check_decode_dtype(model, compute_dtype)
    dev = model.device
    phone_len, prompt_len = phone_len.to(dev), prompt_len.to(dev)
    b, lp = phones.shape
    l0 = lp + prompt_tokens.shape[1]  # every sample ends at l0 - 1
    total = max(l0 + max_new, capacity or 0)
    kv_valid = right_pack_valid([phone_len, prompt_len], l0, total)
    caches = model.make_cache(b, total, dt)
    logits, caches = model.ar_prefill_ragged(phones.to(dev), phone_len,
                                             prompt_tokens.to(dev), prompt_len, caches,
                                             kv_valid)
    return decode_loop(model, caches, logits, l0, max_new, generators, temperature, top_k,
                        1.0, kv_valid)


@torch.inference_mode()
def nar_generate_ragged(model: VALLE, phones, phone_len, tokens0, target_len,
                        prompt_tokens_all, prompt_len, compute_dtype: str = "bfloat16"):
    """Ragged batched NAR stage (greedy) → (B, Q, T_max) codes. int8/int4
    run the NAR in bf16, as JAX does."""
    _nar_dtype(model, compute_dtype)
    dev = model.device
    return _nar_generate_ragged(model, phones.to(dev), phone_len.to(dev), tokens0.to(dev),
                                target_len.to(dev), prompt_tokens_all.to(dev),
                                prompt_len.to(dev))


def valle_generate_ragged(model: VALLE, phones, phone_len, prompt_tokens_all, prompt_len,
                          generators=None, max_new: int = 512, temperature: float = 1.0,
                          top_k: int = 50, compute_dtype: str = "bfloat16"):
    """Ragged zero-shot decode, AR then NAR, the prompt's full codes
    (B, Q, Lp) conditioning the NAR as a prefix → (codes (B, Q, max_new),
    gen_len (B,))."""
    toks0, gen_len = ar_generate_ragged(
        model, phones, phone_len, prompt_tokens_all[:, 0], prompt_len, generators,
        max_new=max_new, temperature=temperature, top_k=top_k, compute_dtype=compute_dtype)
    codes = nar_generate_ragged(model, phones, phone_len, toks0, gen_len, prompt_tokens_all,
                                prompt_len, compute_dtype=compute_dtype)
    return codes, gen_len
