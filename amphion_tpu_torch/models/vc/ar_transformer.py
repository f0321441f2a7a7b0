"""Vevo autoregressive transformer, decode path (port of
`amphion_tpu/models/vc/ar_transformer.py`): content tokens → content-style
tokens through a KV-cache Llama decoder.

One unified token space (as JAX): output ids raw in [0, output_vocab),
input ids shifted by +output_vocab, then pad = in + out and
input_bos/input_eos/output_bos/output_eos = pad + 1..4; the vocabulary
has 20 more slots. The decode loop is a Python loop of ``max_new`` steps
that runs every step, as the JAX ``lax.scan`` does, and never waits on
the card: stop tokens are handled by masks on the device.

Quantized decode (``compute_dtype`` int8 or int4) is prepared once, by
`prepare_for_decode` when the pipeline is built: the weights are cast to
bf16, every decoder projection is quantized (fused q/k/v and gate/up), and
the int8 KV cache is on unless ``AMPHION_KV_QUANT=0``. ``lm_head`` stays
bf16 and unquantized, as in JAX.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import torch
from torch import nn

from amphion_tpu_torch.modules.llama import (
    LlamaConfig,
    LlamaDecoder,
    cast_params,
    load_quantized,
)
from amphion_tpu_torch.ops.ragged import pack_segments_right, right_pack_valid
from amphion_tpu_torch.ops.sampling import sample_logits

DECODE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.bfloat16, "int4": torch.bfloat16}


@dataclass(frozen=True)
class ARTransformerConfig:
    input_vocab: int = 32  # content tokens
    output_vocab: int = 8192  # content-style tokens
    style_vocab: int = 0  # the Vevo1.5 prosody stream is not ported
    hidden: int = 1024
    intermediate: int | None = 4096
    num_layers: int = 16
    num_heads: int = 16
    max_position: int = 8192
    use_global_timbre: bool = False  # not ported: off in every Vevo config
    decode_quant: str = "none"  # "none" | "int8" | "int4"
    kv_quant: bool = False

    def __post_init__(self):
        if self.use_global_timbre:
            raise NotImplementedError("the global timbre encoder is not ported")
        if self.style_vocab:
            raise NotImplementedError("the prosody-style token stream is not ported")

    @property
    def pad_id(self) -> int:
        return self.input_vocab + self.style_vocab + self.output_vocab

    @property
    def input_bos_id(self) -> int:
        return self.pad_id + 1

    @property
    def input_eos_id(self) -> int:
        return self.pad_id + 2

    @property
    def bos_id(self) -> int:  # output BOS
        return self.pad_id + 3

    @property
    def eos_id(self) -> int:  # output EOS (decode stop token)
        return self.pad_id + 4

    @property
    def input_shift(self) -> int:
        return self.style_vocab + self.output_vocab

    @property
    def total_vocab(self) -> int:
        return self.input_vocab + self.style_vocab + self.output_vocab + 20

    def llama(self) -> LlamaConfig:
        return LlamaConfig(
            hidden_size=self.hidden, num_layers=self.num_layers,
            num_heads=self.num_heads, intermediate_size=self.intermediate,
            max_position=self.max_position, decode_quant=self.decode_quant,
            kv_quant=self.kv_quant)


class ARTransformer(nn.Module):
    def __init__(self, cfg: ARTransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.total_vocab, cfg.hidden)
        self.decoder = LlamaDecoder(cfg.llama())
        self.lm_head = nn.Linear(cfg.hidden, cfg.total_vocab, bias=False)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def prefill(self, input_tokens, caches, prompt_output_tokens=None):
        """Prompt [IN_BOS, inputs, IN_EOS, OUT_BOS, prompt outputs] written
        at cache position 0 → (last logits, caches, prompt length)."""
        c = self.cfg
        b = input_tokens.shape[0]
        dev = input_tokens.device

        def full(v):
            return torch.full((b, 1), v, dtype=torch.long, device=dev)

        ids = [full(c.input_bos_id), input_tokens.long() + c.input_shift,
               full(c.input_eos_id), full(c.bos_id)]
        if prompt_output_tokens is not None:
            ids.append(prompt_output_tokens.long())
        x = self.embed_tokens(torch.cat(ids, dim=1))
        h, caches = self.decoder.forward_cached(x, caches, 0)
        return self.lm_head(h[:, -1]), caches, x.shape[1]

    def prefill_ragged(self, input_tokens, input_len, caches, kv_valid,
                       prompt_output_tokens=None, prompt_output_len=None,
                       cache_index: int = 0):
        """Ragged prefill: per-sample ``[pad | IN_BOS inputs_i IN_EOS |
        OUT_BOS prompt_outputs_i]`` right-aligned, pad slots masked by
        ``kv_valid`` → (last logits, caches, packed length)."""
        c = self.cfg
        b, li = input_tokens.shape
        dev = input_tokens.device
        input_len = input_len.to(dev, torch.long)
        pos = torch.arange(li + 2, device=dev)[None, :]
        in_ids = torch.cat([
            torch.full((b, 1), c.input_bos_id, dtype=torch.long, device=dev),
            input_tokens.long() + c.input_shift,
            torch.zeros((b, 1), dtype=torch.long, device=dev)], dim=1)
        in_ids = torch.where(pos == input_len[:, None] + 1, c.input_eos_id, in_ids)
        out_ids = [torch.full((b, 1), c.bos_id, dtype=torch.long, device=dev)]
        out_lens = torch.ones((b,), dtype=torch.long, device=dev)
        if prompt_output_tokens is not None:
            out_ids.append(prompt_output_tokens.long())
            out_lens = out_lens + prompt_output_len.to(dev, torch.long)
        ids = pack_segments_right([in_ids, torch.cat(out_ids, dim=1)],
                                  [input_len + 2, out_lens])
        h, caches = self.decoder.forward_cached(self.embed_tokens(ids), caches,
                                                cache_index, kv_valid)
        return self.lm_head(h[:, -1]), caches, ids.shape[1]

    def step(self, token, caches, cache_index: int, kv_valid=None):
        h, caches = self.decoder.forward_cached(self.embed_tokens(token)[:, None, :],
                                                caches, cache_index, kv_valid)
        return self.lm_head(h[:, -1]), caches


def prepare_for_decode(model: ARTransformer, compute_dtype: str) -> ARTransformer:
    """The model a decode in ``compute_dtype`` runs (JAX
    `_quantize_for_decode`): float32/bf16 cast the parameters; int8/int4
    rebuild the model with quantized decoder projections from its
    bf16-cast weights and, unless ``AMPHION_KV_QUANT=0``, the int8 KV cache.
    Call once, when the pipeline is built."""
    if compute_dtype not in DECODE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r} not in {tuple(DECODE_DTYPES)}")
    if compute_dtype in ("float32", "bfloat16"):
        return cast_params(model, DECODE_DTYPES[compute_dtype])
    qcfg = dataclasses.replace(model.cfg, decode_quant=compute_dtype,
                               kv_quant=os.environ.get("AMPHION_KV_QUANT", "1") != "0")
    with torch.device(model.device):
        qmodel = ARTransformer(qcfg)
    return load_quantized(qmodel, model, qcfg.llama())


def _check(model: ARTransformer, compute_dtype: str) -> torch.dtype:
    if compute_dtype not in DECODE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r} not in {tuple(DECODE_DTYPES)}")
    quant = compute_dtype if compute_dtype in ("int8", "int4") else "none"
    dt = DECODE_DTYPES[compute_dtype]
    if model.cfg.decode_quant != quant or model.embed_tokens.weight.dtype != dt:
        raise ValueError(
            f"the AR model holds {model.cfg.decode_quant} projections and "
            f"{model.embed_tokens.weight.dtype} weights but compute_dtype is "
            f"{compute_dtype}: prepare it once with prepare_for_decode")
    return dt


def _decode_loop(model, caches, logits, start: int, max_new: int, generators,
                 temperature, top_k, top_p, kv_valid=None):
    eos = model.cfg.eos_id
    b = logits.shape[0]
    dev = logits.device
    gen_len = torch.zeros((b,), dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    toks = []
    for i in range(max_new):
        tok = sample_logits(logits.float(), generators, temperature, top_k, top_p)
        done = done | (tok == eos)
        tok = torch.where(done, 0, tok)
        logits, caches = model.step(tok, caches, start + i, kv_valid)
        gen_len = torch.where(done, gen_len, i + 1)
        toks.append(tok)
    return torch.stack(toks, dim=1), gen_len


@torch.inference_mode()
def ar_transformer_generate(model: ARTransformer, input_tokens: torch.Tensor,
                            generator: torch.Generator | None = None,
                            max_new: int = 1024, temperature: float = 1.0,
                            top_k: int = 40, top_p: float = 1.0,
                            prompt_output_tokens: torch.Tensor | None = None,
                            compute_dtype: str = "bfloat16"):
    """KV-cache sampled decode of a (B, Li) batch of equal-length inputs,
    one ``generator`` for the batch → (tokens (B, max_new) raw output ids,
    0 from a row's EOS on; lengths (B,))."""
    dt = _check(model, compute_dtype)
    b, li = input_tokens.shape
    plen = 0 if prompt_output_tokens is None else prompt_output_tokens.shape[1]
    total = li + 3 + plen + max_new
    caches = model.decoder.init_cache(b, total, dt, model.device)
    logits, caches, pref_len = model.prefill(input_tokens.to(model.device), caches,
                                             None if prompt_output_tokens is None
                                             else prompt_output_tokens.to(model.device))
    return _decode_loop(model, caches, logits, pref_len, max_new, generator,
                        temperature, top_k, top_p)


@torch.inference_mode()
def ar_transformer_generate_ragged(model: ARTransformer, input_tokens: torch.Tensor,
                                   input_len: torch.Tensor,
                                   generators: list[torch.Generator] | None = None,
                                   max_new: int = 1024, temperature: float = 1.0,
                                   top_k: int = 40, top_p: float = 1.0,
                                   prompt_output_tokens: torch.Tensor | None = None,
                                   prompt_output_len: torch.Tensor | None = None,
                                   compute_dtype: str = "bfloat16"):
    """Ragged batched decode (the serving path): B requests with their own
    content (and output-prompt) lengths, right-padded buffers with (B,)
    lengths, one generator per request, so a request's draws do not depend
    on the batch → (tokens (B, max_new), lengths (B,))."""
    dt = _check(model, compute_dtype)
    dev = model.device
    b, li = input_tokens.shape
    input_len = input_len.to(dev, torch.long)
    lo = 1 if prompt_output_tokens is None else 1 + prompt_output_tokens.shape[1]
    l0 = li + 2 + lo  # shared prefill length: every sample ends at l0 - 1
    total = l0 + max_new
    out_lens = torch.ones((b,), dtype=torch.long, device=dev)
    if prompt_output_tokens is not None:
        out_lens = out_lens + prompt_output_len.to(dev, torch.long)
        prompt_output_tokens = prompt_output_tokens.to(dev)
    kv_valid = right_pack_valid([input_len + 2, out_lens], l0, total)
    caches = model.decoder.init_cache(b, total, dt, dev)
    logits, caches, _ = model.prefill_ragged(
        input_tokens.to(dev), input_len, caches, kv_valid, prompt_output_tokens,
        prompt_output_len)
    return _decode_loop(model, caches, logits, l0, max_new, generators, temperature,
                        top_k, top_p, kv_valid)
