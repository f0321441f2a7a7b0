"""Llama-style backbone (port of `amphion_tpu/modules/llama.py`): the NAR
encoder with adaptive RMSNorm (the flow-matching estimator) and the AR
decoder with a KV cache (the Vevo AR), each with optional weight-only
int8/int4 projections.

Submodules carry the Flax scope names (``layer_3.attn.q_proj``,
``input_norm.to_weight``, ``attn.qkv_proj``, ``Dense_0``) so
`utils/convert.from_flax` can load a JAX parameter tree with one generic
walk. Full-sequence attention always goes through
`ops/kernels/flash_attention.flash_attention`; quantized projections go
through `ops/kernels/int8_matmul` (kernel 4) and `ops/kernels/int4_matmul`
(kernel 5), the single-step decode over the int8 KV cache, when
``AMPHION_FUSED_DECODE_ATTN`` is set, through
`ops/kernels/decode_attention` (kernel 8), and the decoder's norms in its
cached path through `ops/kernels/rms_norm` (a row-invariant RMSNorm): each
the CUDA kernel on a CUDA tensor, its plain version on the CPU.

The decoder's caches are preallocated and written in place (JAX returns
new arrays): ``LlamaDecoder.forward_cached`` returns the same list it was
given. A decode step takes one shared position (an int) or one per row (a
(B,) tensor, the continuous engine's cursors, as the JAX engine's `vmap`
gives each lane its own ``cache_index``); with a tensor nothing reads a
value on the host, so the step can be captured in a CUDA graph.

`DiffLlamaEncoder` and `DiffLlamaPrefixEncoder` are the MaskGCT S2A and
T2S backbones over the adaptive `LlamaEncoder` (kernel 6 with the key mask
in every layer).

Training: with ``LlamaConfig.remat`` each block runs under
``torch.utils.checkpoint`` (the JAX ``nn.remat``), and full-sequence
attention is differentiable through the flash kernels' autograd Function
(kernel 6 forward, kernel 7 backward).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from amphion_tpu_torch.ops.kernels.decode_attention import decode_attention_int8
from amphion_tpu_torch.ops.kernels.flash_attention import flash_attention
from amphion_tpu_torch.ops.kernels.int4_matmul import (
    int4_matmul,
    pack_int4,
    quantize_weight_int4,
)
from amphion_tpu_torch.ops.kernels.int8_matmul import int8_matmul, quantize_weight_int8
from amphion_tpu_torch.ops.kernels.rms_norm import rms_norm, rms_norm_ref

QUANTS = ("none", "int8", "int4")


@dataclass(frozen=True)
class LlamaConfig:
    hidden_size: int = 1024
    num_layers: int = 16
    num_heads: int = 16
    num_kv_heads: int | None = None  # GQA; None = MHA
    intermediate_size: int | None = None  # None = Llama's 8/3 * hidden
    rope_theta: float = 1e4
    max_position: int = 4096
    adaptive: bool = False  # adaptive RMSNorm on a conditioning vector
    # "none" | "int8" | "int4": weight-only quantized projections (QDense,
    # QDense4), q/k/v fused into one qkv_proj and gate/up into one
    # gateup_proj (4 matmuls per layer instead of 7); build the matching
    # state with `quantize_llama_params`
    decode_quant: str = "none"
    kv_quant: bool = False  # int8 head-major KV cache in `LlamaDecoder`
    remat: bool = False  # recompute each block's activations in the backward

    def __post_init__(self):
        if self.decode_quant not in QUANTS:
            raise ValueError(f"decode_quant {self.decode_quant!r} not in {QUANTS}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def ffn_dim(self) -> int:
        if self.intermediate_size is not None:
            return self.intermediate_size
        d = int(2 * 4 * self.hidden_size / 3)
        return (d + 255) // 256 * 256


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x, passthrough: bool = False):
        """``passthrough`` returns (x, scale) unnormalised, for a matmul that
        applies the norm as its prologue (kernel 5)."""
        if passthrough:
            return x, self.scale
        return rms_norm_ref(x, self.scale, self.eps)

    def forward_cached(self, x):
        """The norm as the decoder's cached path runs it: one fixed-order
        reduction per row (kernel `rms_norm` on the card), so a row's
        result does not depend on the rows beside it."""
        return rms_norm(x, self.scale, self.eps)


class AdaptiveRMSNorm(nn.Module):
    """RMSNorm whose scale is ``Linear(cond)`` (zero weight and unit bias at
    init, so it starts as plain RMSNorm without a learned scale)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.to_weight = nn.Linear(dim, dim)
        nn.init.zeros_(self.to_weight.weight)
        nn.init.ones_(self.to_weight.bias)

    def forward(self, x, cond):
        var = x.float().pow(2).mean(dim=-1, keepdim=True)
        normed = (x * torch.rsqrt(var + self.eps)).to(x.dtype)
        weight = self.to_weight(cond)
        if weight.ndim == 2:
            weight = weight[:, None, :]
        return normed * weight


def rotary_tables(max_pos: int, head_dim: int, theta: float = 1e4, device=None):
    """(cos, sin), each (max_pos, head_dim/2) float32, computed in float64 on
    ``device`` (rounded once, as the JAX tables are)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64,
                                        device=device) / head_dim))
    freqs = torch.outer(torch.arange(max_pos, dtype=torch.float64, device=device), inv)
    return freqs.cos().float(), freqs.sin().float()


def full_rotary_tables(cos: torch.Tensor, sin: torch.Tensor):
    """(T, D/2) tables → full-width (T, D) ``[cos | cos]`` and ``[-sin | sin]``,
    so a rotation is two products and a sum."""
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 keep_f32: bool = False):
    """x (B, T, H, D); cos/sin (T, D/2), or full width (T, D) from
    `full_rotary_tables`, or (B, T, D) with a row each. Rotates in float32,
    ``[x1 c - x2 s | x2 c + x1 s]`` (as ``x c + rot(x) s`` with the same
    roundings), and returns x's dtype,
    or float32 with ``keep_f32`` (the JAX decoder's promotion: its bf16 q/k
    times the float32 tables stay float32)."""
    if 2 * cos.shape[-1] == x.shape[-1]:
        cos, sin = full_rotary_tables(cos, sin)
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    out = xf * cos[:, :, None, :] + torch.cat([x2, x1], dim=-1) * sin[:, :, None, :]
    return out if keep_f32 else out.to(x.dtype)


# -- weight-only quantized projections -----------------------------------------


def int4_group(k_in: int) -> int:
    """Largest group size ≤ 128 dividing K (sub-channel int4 scales)."""
    for g in (128, 64, 32, 16, 8, 4, 2):
        if k_in % g == 0:
            return g
    raise ValueError(f"int4 decode needs even K, got {k_in}")


class QDense(nn.Module):
    """Weight-only int8 projection without bias: buffers ``kernel_q``
    (N, K) int8 (the transpose of the Flax kernel_q) and ``scale`` (N,)
    float32, applied by kernel 4. Output in x's dtype."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.register_buffer("kernel_q", torch.zeros((features, in_features), dtype=torch.int8))
        self.register_buffer("scale", torch.ones(features))

    def forward(self, x):
        x2 = x.reshape(-1, x.shape[-1])
        out = int8_matmul(x2, self.kernel_q, self.scale, out_dtype=x.dtype)
        return out.reshape(*x.shape[:-1], -1)


class QDense4(nn.Module):
    """Weight-only int4 projection without bias: buffers ``kernel_q``
    (N, K/2) uint8, two values per byte along K, and ``scale``
    (K/group, N) float32, applied by kernel 5, with the RMSNorm prologue
    when ``rms_scale`` is given. Output in x's dtype."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.group = int4_group(in_features)
        self.register_buffer("kernel_q", torch.zeros((features, in_features // 2),
                                                     dtype=torch.uint8))
        self.register_buffer("scale", torch.ones((in_features // self.group, features)))

    def forward(self, x, rms_scale=None):
        x2 = x.reshape(-1, x.shape[-1])
        out = int4_matmul(x2, self.kernel_q, self.scale, self.group,
                          rms_scale=rms_scale, rms_eps=1e-6, out_dtype=x.dtype)
        return out.reshape(*x.shape[:-1], -1)


def cast_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the floating parameters of ``module`` to ``dtype`` in place,
    leaving buffers (the quantized projections' float32 scales) as they
    are; returns the module."""
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module


def _proj(cfg: LlamaConfig, in_features: int, features: int) -> nn.Module:
    if cfg.decode_quant == "int8":
        return QDense(in_features, features)
    if cfg.decode_quant == "int4":
        return QDense4(in_features, features)
    return nn.Linear(in_features, features, bias=False)


PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
FUSED = {"qkv_proj": ("q_proj", "k_proj", "v_proj"), "gateup_proj": ("gate_proj", "up_proj")}


def quantize_llama_params(state: dict, quant: str = "int8") -> dict:
    """Float state dict → quantized-projection state dict: q/k/v concatenate
    along N into ``<scope>.qkv_proj`` and gate/up into ``gateup_proj``
    (exact, since the scales are per output column), then every projection
    ``(N, K)`` weight becomes ``kernel_q``/``scale`` buffers
    (`quantize_weight_int8`, or `quantize_weight_int4` packed along K with
    `int4_group`); other entries pass through. Quantizes in the weights' own
    dtype, as JAX does: pass a bf16 state for the decode path."""
    if quant not in ("int8", "int4"):
        raise ValueError(f"quantize_llama_params: quant {quant!r} is not int8/int4")

    def qdict(prefix, w):
        if quant == "int4":
            w_int, scale = quantize_weight_int4(w, int4_group(w.shape[1]))
            return {f"{prefix}.kernel_q": pack_int4(w_int), f"{prefix}.scale": scale}
        w_q, scale = quantize_weight_int8(w)
        return {f"{prefix}.kernel_q": w_q, f"{prefix}.scale": scale}

    def proj_of(key):
        parts = key.split(".")
        if len(parts) >= 2 and parts[-1] == "weight" and parts[-2] in PROJ_NAMES:
            return ".".join(parts[:-2]), parts[-2]
        return None

    out, done = {}, set()
    for key, val in state.items():
        hit = proj_of(key)
        if hit is None or val.ndim != 2:
            out[key] = val
            continue
        scope, name = hit
        dot = f"{scope}." if scope else ""
        fused = next((f for f, names in FUSED.items() if name in names), None)
        if fused is None:
            out.update(qdict(f"{dot}{name}", val))
            continue
        if (scope, fused) in done:
            continue
        missing = [n for n in FUSED[fused] if f"{dot}{n}.weight" not in state]
        if missing:
            raise ValueError(f"quantize_llama_params: {dot}{fused} needs "
                             f"{FUSED[fused]}, missing {missing}")
        done.add((scope, fused))
        w = torch.cat([state[f"{dot}{n}.weight"] for n in FUSED[fused]], dim=0)
        out.update(qdict(f"{dot}{fused}", w))
    return out


@torch.no_grad()
def load_quantized(qmodel: nn.Module, model: nn.Module, cfg: LlamaConfig) -> nn.Module:
    """Fill ``qmodel`` (built with quantized projections per ``cfg``) from the
    float ``model``: every weight cast to bf16, as the JAX decode prep casts,
    and every projection quantized from it; ``qmodel``'s parameters become
    bf16 and its scales stay float32. Returns ``qmodel`` in eval mode."""
    state = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
             for k, v in model.state_dict().items()}
    state = quantize_llama_params(state, cfg.decode_quant)
    validate_quantized_tree(state, cfg)
    cast_params(qmodel, torch.bfloat16).load_state_dict(state)
    return qmodel.eval()


def validate_quantized_tree(state: dict, cfg: LlamaConfig) -> None:
    """Raise when a quantized state holds unfused projections (separate
    q/k/v or gate/up ``kernel_q``, as JAX's ``fuse=False`` writes them): the
    port's quantized layout is the fused one, and the mismatch would
    otherwise surface as missing keys at load time. No-op for unquantized
    configs."""
    if cfg.decode_quant == "none":
        return
    unfused = sorted({n for k in state for names in FUSED.values() for n in names
                      if k == f"{n}.kernel_q" or k.endswith(f".{n}.kernel_q")})
    if unfused:
        raise ValueError(
            f"quantized state is UNFUSED (separate {unfused} projections); the "
            "port expects fused qkv_proj/gateup_proj: re-quantize with "
            "quantize_llama_params")


# -- attention, MLP, blocks -------------------------------------------------------


def _q8(x: torch.Tensor):
    """(B, T, H, D) float32 → head-major int8 (B, H, T, D) and its
    per-(position, head) scales (B, H, T): amax/127, floored at 1e-8."""
    x = x.transpose(1, 2)
    # jitted JAX computes ``amax / 127.0`` as a multiply by float32(1/127)
    s = torch.clamp(x.abs().amax(dim=-1) * torch.tensor(1.0 / 127.0, dtype=torch.float32),
                    min=1e-8)
    return torch.round(x / s[..., None]).to(torch.int8), s.float()


def _per_row_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over (B, H, ...) operands, one batch row at a time: cuBLAS
    picks its batched product by the batch count (B·H), and on the card a
    decode step's scores and values changed a row's bits between 1 and 4
    rows; one product per row gives each row the product a lone row gets."""
    return torch.cat([torch.matmul(a[i:i + 1], b[i:i + 1]) for i in range(a.shape[0])])


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        nq, nkv = cfg.num_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
        if cfg.decode_quant != "none":
            self.qkv_proj = _proj(cfg, h, nq + 2 * nkv)
        else:
            self.q_proj = _proj(cfg, h, nq)
            self.k_proj = _proj(cfg, h, nkv)
            self.v_proj = _proj(cfg, h, nkv)
        self.o_proj = _proj(cfg, nq, h)

    def _qkv(self, x, rms_scale=None):
        c = self.cfg
        b, t, _ = x.shape
        nq, nkv = c.num_heads * c.head_dim, c.kv_heads * c.head_dim
        if hasattr(self, "qkv_proj"):
            qkv = (self.qkv_proj(x, rms_scale) if rms_scale is not None
                   else self.qkv_proj(x))
            q, k, v = qkv.split([nq, nkv, nkv], dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        return (q.reshape(b, t, c.num_heads, c.head_dim),
                k.reshape(b, t, c.kv_heads, c.head_dim),
                v.reshape(b, t, c.kv_heads, c.head_dim))

    def forward(self, x, cos, sin, kv_mask=None, causal=False):
        """Full-sequence attention through the flash kernel."""
        c = self.cfg
        b, t, _ = x.shape
        q, k, v = self._qkv(x)
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        out = flash_attention(q, k, v.contiguous(), kv_mask, causal)
        return self.o_proj(out.reshape(b, t, c.num_heads * c.head_dim))

    def forward_cached(self, x, cos, sin, cache, cache_index, allowed,
                       biased: bool = False, kv_mask=None, rms_scale=None):
        """x (B, T, D) new tokens at positions ``cache_index + arange(T)``
        (cos/sin are those rows of the full-width tables), or, with
        ``cache_index`` a (B,) tensor and T = 1, row b's token at position
        ``cache_index[b]`` (cos/sin (B, 1, D)); their K/V are written into
        ``cache`` in place. ``allowed`` (B or 1, 1, T, S) bool
        marks the keys each query may attend (causality, ``kv_mask`` and the
        prefill's ``kv_valid`` combined, once per step, by the decoder);
        ``biased`` says the JAX path would carry it as an additive bias (the
        prefill), which sends an int8 cache to the dense dequantizing tail;
        ``kv_mask`` (B, S), the single-step key mask, only decides whether
        the fused kernel may run. With ``rms_scale``, x is the unnormalised
        block input and the RMSNorm runs as the int4 qkv matmul's
        prologue."""
        c = self.cfg
        b, t, _ = x.shape
        dt = x.dtype
        h, hkv = c.num_heads, c.kv_heads
        q, k, v = self._qkv(x, rms_scale)
        qk = apply_rotary(torch.cat([q, k], dim=2), cos, sin, keep_f32=True)
        q, k = qk[:, :, :h], qk[:, :, h:]
        per_row = torch.is_tensor(cache_index)
        if per_row:  # one position a row: write row b at cache_index[b]
            rows = torch.arange(b, device=x.device)
            at = (rows, slice(None), cache_index)  # head-major int8 cache
            at_dense = (rows, cache_index)
        else:
            at = (slice(None), slice(None), slice(cache_index, cache_index + t))
            at_dense = (slice(None), slice(cache_index, cache_index + t))
        mha = hkv == h
        neg = torch.finfo(torch.float32).min
        if len(cache) == 4:  # int8 head-major cache (B, H, S, D) + scales (B, H, S)
            ck, cv, ks, vs = cache
            kvq, kvs = _q8(torch.cat([k, v.float()], dim=2))
            if per_row:
                kvq, kvs = kvq[:, :, 0], kvs[:, :, 0]
            ck[at] = kvq[:, :hkv]
            cv[at] = kvq[:, hkv:]
            ks[at] = kvs[:, :hkv]
            vs[at] = kvs[:, hkv:]
            if (mha and not biased and t == 1 and kv_mask is None and not per_row
                    and os.environ.get("AMPHION_FUSED_DECODE_ATTN")):
                valid = torch.full((b,), cache_index + 1, dtype=torch.int32, device=x.device)
                o = decode_attention_int8(q[:, 0].contiguous(), ck, cv, ks, vs, valid)
                return self.o_proj(o.to(dt).reshape(b, 1, h * c.head_dim))
            if mha and not biased:
                # scale after the dot: the per-(position, head) scales factor
                # out of the head-dim contraction, so they multiply the scores
                # and the probabilities, in the working dtype, as in JAX (the
                # int8 cache is exact in bf16 and float32 alike)
                scores = _per_row_matmul(q.transpose(1, 2), ck.float().transpose(2, 3))
                scores = scores * ks.to(dt).float()[:, :, None, :] / np.sqrt(c.head_dim)
                probs = torch.softmax(scores.masked_fill(~allowed, neg), dim=-1).to(dt)
                probs = probs * vs.to(dt)[:, :, None, :]
                out = _per_row_matmul(probs, cv.to(dt)).transpose(1, 2)
                return self.o_proj(out.reshape(b, t, h * c.head_dim))
            # dense dequantizing tail (a mask bias, or GQA)
            k = (ck.to(dt) * ks.to(dt)[..., None]).transpose(1, 2)
            v = (cv.to(dt) * vs.to(dt)[..., None]).transpose(1, 2)
        else:  # dense cache (B, S, Hkv, D)
            ck, cv = cache
            ck[at_dense] = (k[:, 0] if per_row else k).to(ck.dtype)
            cv[at_dense] = (v[:, 0] if per_row else v).to(cv.dtype)
            k, v = ck, cv
        if not mha:
            k = k.repeat_interleave(h // hkv, dim=2)
            v = v.repeat_interleave(h // hkv, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k.float()) / np.sqrt(c.head_dim)
        probs = torch.softmax(scores.masked_fill(~allowed, neg), dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(dt))
        return self.o_proj(out.reshape(b, t, h * c.head_dim))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        h, f = cfg.hidden_size, cfg.ffn_dim
        if cfg.decode_quant != "none":
            self.gateup_proj = _proj(cfg, h, 2 * f)
        else:
            self.gate_proj = _proj(cfg, h, f)
            self.up_proj = _proj(cfg, h, f)
        self.down_proj = _proj(cfg, f, h)

    def forward(self, x, rms_scale=None):
        if hasattr(self, "gateup_proj"):
            gu = (self.gateup_proj(x, rms_scale) if rms_scale is not None
                  else self.gateup_proj(x))
            gate, up = gu.chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        norm = AdaptiveRMSNorm if cfg.adaptive else RMSNorm
        self.input_norm = norm(cfg.hidden_size)
        self.attn = LlamaAttention(cfg)
        self.post_norm = norm(cfg.hidden_size)
        self.mlp = LlamaMLP(cfg)

    def _norm(self, norm, x, cond):
        return norm(x, cond) if self.cfg.adaptive else norm(x)

    def forward(self, x, cos, sin, cond=None, kv_mask=None, causal=False):
        x = x + self.attn(self._norm(self.input_norm, x, cond), cos, sin,
                          kv_mask, causal)
        return x + self.mlp(self._norm(self.post_norm, x, cond))

    def forward_cached(self, x, cos, sin, cache, cache_index, allowed, biased=False,
                       kv_mask=None):
        c = self.cfg
        # fused-RMSNorm decode: the int4 qkv and gateup matmuls normalise x
        # in their prologue (switch read as the JAX block reads it)
        fuse_rms = (c.decode_quant == "int4" and not c.adaptive
                    and os.environ.get("AMPHION_FUSED_RMS") == "1")
        if fuse_rms:
            h, in_scale = self.input_norm(x, passthrough=True)
        else:
            h, in_scale = self.input_norm.forward_cached(x), None
        x = x + self.attn.forward_cached(h, cos, sin, cache, cache_index, allowed, biased,
                                         kv_mask, rms_scale=in_scale)
        if fuse_rms:
            h, post_scale = self.post_norm(x, passthrough=True)
        else:
            h, post_scale = self.post_norm.forward_cached(x), None
        return x + self.mlp(h, rms_scale=post_scale)


def _run_block(cfg: LlamaConfig, block: nn.Module, x, *args):
    """One block, under activation checkpointing when ``cfg.remat`` and a
    gradient is being recorded (as JAX wraps it in ``nn.remat``)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(block, x, *args, use_reentrant=False)
    return block(x, *args)


class LlamaEncoder(nn.Module):
    """Bidirectional stack; ``adaptive=True`` conditions every norm on a
    (B, D) vector (the diffusion/flow time embedding)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", LlamaBlock(cfg))
        self.final_norm = (AdaptiveRMSNorm if cfg.adaptive else RMSNorm)(
            cfg.hidden_size)

    def forward(self, x, cond=None, mask=None):
        """x (B, T, D); mask (B, T), nonzero = a real position."""
        c = self.cfg
        t = x.shape[1]
        if t > c.max_position:
            raise ValueError(f"sequence of {t} exceeds max_position {c.max_position}")
        cos, sin = rotary_tables(t, c.head_dim, c.rope_theta, x.device)
        for i in range(c.num_layers):
            x = _run_block(c, getattr(self, f"layer_{i}"), x, cos, sin, cond, mask)
        return self.final_norm(x, cond) if c.adaptive else self.final_norm(x)


class LlamaDecoder(nn.Module):
    """Causal stack: a full-sequence forward (training), or decoding through
    a KV cache: a prefill of T tokens, then single-token steps."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        if cfg.adaptive:
            raise ValueError("LlamaDecoder takes a plain (non-adaptive) config")
        self.cfg = cfg
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", LlamaBlock(cfg))
        self.final_norm = RMSNorm(cfg.hidden_size)
        self._rope = {}

    def forward(self, x, mask=None):
        """Causal forward over the whole sequence x (B, T, D) (the JAX
        ``__call__`` without caches): ``mask`` (B, T), nonzero = a real
        position, is the key mask of the causal flash attention."""
        c = self.cfg
        t = x.shape[1]
        if t > c.max_position:
            raise ValueError(f"sequence of {t} exceeds max_position {c.max_position}")
        cos, sin = rotary_tables(t, c.head_dim, c.rope_theta, x.device)
        for i in range(c.num_layers):
            x = _run_block(c, getattr(self, f"layer_{i}"), x, cos, sin, None, mask, True)
        return self.final_norm(x)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32, device=None):
        """Per-layer caches: with ``kv_quant`` the int8 head-major
        (B, H, S, D) K and V with float32 (B, H, S) scales, else (B, S, Hkv, D)
        K and V in ``dtype``."""
        c = self.cfg
        if device is None:
            device = self.final_norm.scale.device
        if c.kv_quant:
            shape = (batch, c.kv_heads, max_len, c.head_dim)
            return [(torch.zeros(shape, dtype=torch.int8, device=device),
                     torch.zeros(shape, dtype=torch.int8, device=device),
                     torch.zeros(shape[:3], device=device),
                     torch.zeros(shape[:3], device=device))
                    for _ in range(c.num_layers)]
        shape = (batch, max_len, c.kv_heads, c.head_dim)
        return [(torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device))
                for _ in range(c.num_layers)]

    def _tables(self, device):
        """Full-width rotary tables over ``max_position``, once per device."""
        if device not in self._rope:
            c = self.cfg
            self._rope[device] = full_rotary_tables(
                *rotary_tables(c.max_position, c.head_dim, c.rope_theta, device))
        return self._rope[device]

    def forward_cached(self, x, caches, cache_index, kv_valid=None):
        """x (B, T, D) appended at ``cache_index`` → (hidden, caches).

        ``cache_index`` is an int, the position of the first new token in
        every row, or, for a step (T == 1), a (B,) int tensor of each row's
        own position (its cursor), which the caller keeps below
        ``max_position``. ``kv_valid`` (B, S) marks the cache slots that
        hold real content (the ragged serving layout left-pads shorter
        prompts). In a prefill (T > 1) a pad query keeps its own slot
        attendable, so no softmax row is fully masked; in a step (T == 1)
        the validity is a key mask, not a bias, which keeps the int8
        cache's fast paths. The mask is built once here for every layer."""
        c = self.cfg
        t = x.shape[1]
        cos_t, sin_t = self._tables(x.device)
        s_len = caches[0][0].shape[2 if len(caches[0]) == 4 else 1]
        k_pos = torch.arange(s_len, device=x.device)[None, :]
        if torch.is_tensor(cache_index):
            if t != 1:
                raise ValueError("per-row positions take one token a row")
            cache_index = cache_index.long()
            cos, sin = cos_t[cache_index][:, None], sin_t[cache_index][:, None]
            allowed = (k_pos <= cache_index[:, None])[:, None, None, :]
        else:
            end = cache_index + t
            if end > c.max_position:
                raise ValueError(f"position {end} exceeds max_position {c.max_position}")
            cos, sin = cos_t[cache_index:end], sin_t[cache_index:end]
            q_pos = cache_index + torch.arange(t, device=x.device)[:, None]
            allowed = (k_pos <= q_pos)[None, None]
        step_mask = None
        if kv_valid is not None:
            if t > 1:
                allowed = allowed & (kv_valid[:, None, None, :] | (k_pos == q_pos)[None, None])
            else:
                step_mask = kv_valid
                allowed = allowed & kv_valid[:, None, None, :]
        for i in range(c.num_layers):
            x = getattr(self, f"layer_{i}").forward_cached(
                x, cos, sin, caches[i], cache_index, allowed, t > 1, step_mask)
        return self.final_norm.forward_cached(x), caches


def sinusoidal_step_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Diffusion-step embedding: exp-spaced frequencies over half the dim,
    [sin | cos], raw t (no time scaling)."""
    half = dim // 2
    scale = np.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -scale)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class MLP2(nn.Module):
    """Linear(4h) → SiLU → Linear(out or h), in the wider of the input's and
    the weights' dtypes, as Flax ``Dense`` promotes (a float32 step
    embedding through bf16 weights stays float32)."""

    def __init__(self, in_dim: int, hidden: int, out: int | None = None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, 4 * hidden)
        self.Dense_1 = nn.Linear(4 * hidden, out or hidden)

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.Dense_0.weight.dtype)

        def dense(layer, h):
            return F.linear(h.to(dt), layer.weight.to(dt), layer.bias.to(dt))
        return dense(self.Dense_1, F.silu(dense(self.Dense_0, x)))


class DiffLlamaEncoder(nn.Module):
    """DiffLlama (the MaskGCT S2A backbone): per-token conditioning added to
    the input through ``cond_mlp``, the diffusion step through the adaptive
    norms."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.cond_mlp = MLP2(cfg.hidden_size, cfg.hidden_size)
        self.diff_step_mlp = MLP2(cfg.hidden_size, cfg.hidden_size)
        self.encoder = LlamaEncoder(cfg)

    def step_cond(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B,) diffusion steps → the norms' (B, D) conditioning in ``dtype``."""
        return self.diff_step_mlp(
            sinusoidal_step_embedding(t, self.cfg.hidden_size)).to(dtype)

    def forward(self, x, t, cond, mask=None):
        """x (B, T, D); t (B,) diffusion step; cond (B, T, D) per token;
        mask (B, T), nonzero = a real position."""
        x = x + self.cond_mlp(cond)
        return self.encoder(x, cond=self.step_cond(t, x.dtype), mask=mask)


class DiffLlamaPrefixEncoder(DiffLlamaEncoder):
    """DiffLlamaPrefix (the MaskGCT T2S backbone): the conditioning (phone
    embeddings) goes through ``cond_mlp`` and is prepended as a prefix; the
    diffusion step goes through the adaptive norms; the prefix positions
    are cut from the output."""

    def forward(self, x, t, x_mask, phone_emb=None, phone_mask=None):
        d = self.step_cond(t, x.dtype)
        if phone_emb is not None:
            h = torch.cat([self.cond_mlp(phone_emb), x], dim=1)
            m = torch.cat([phone_mask.to(x_mask.dtype), x_mask], dim=1)
            lp = phone_emb.shape[1]
        else:
            h, m, lp = x, x_mask, 0
        return self.encoder(h, cond=d, mask=m)[:, lp:]
