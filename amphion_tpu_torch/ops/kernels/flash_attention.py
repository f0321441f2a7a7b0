"""Flash attention: the forward (kernel 6, `csrc/flash_attn_fwd.cu`), the
backward (kernel 7, `csrc/flash_attn_bwd.cu`) and their plain versions.

Port of `flash_attention` (amphion_tpu/ops/pallas_kernels.py:1117) with its
custom VJP: the forward `flash_attention_pallas` (l.781) and the backward
`flash_attention_bwd_pallas` (l.996). Layout as in JAX: q (B, Lq, H, D),
k/v (B, Lk, KVH, D) with KVH dividing H (GQA), an optional key mask (B, Lk)
with 1 = attend, top-left causal masking, and an optional log-sum-exp
(B, H, Lq) in float32.

`flash_attention` goes through `FlashAttentionFn` when autograd needs a
gradient of q, k or v: its forward saves the output and the LSE, its
backward recomputes the probabilities from them (kernel 7). On a CUDA
tensor both directions launch their kernels; on a CPU tensor they run
`attention_ref` and `flash_attention_bwd_ref`, so the CPU tests exercise
the same wiring.
"""

from __future__ import annotations

import math

import torch

from amphion_tpu_torch.ops.kernels._build import Fl, I, Kernel, P

FLASH = Kernel("flash_attn_fwd",
               {"flash_attn_fwd": [P, P, P, P, P, P, I, I, I, I, I, I, I, I, Fl, P]})
# one launch = the dQ kernel and the dK/dV kernel of one backward
FLASH_BWD = Kernel("flash_attn_bwd",
                   {"flash_attn_bwd": [P] * 10 + [I] * 8 + [Fl, P]})


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: torch.Tensor | None = None, causal: bool = False,
                  return_lse: bool = False):
    """Dense float32 attention with the kernel's masking (masked scores are
    -1e30), mirroring the JAX ``_attention_dense_ref``; output in q's dtype.
    A row with every key masked attends uniformly here, where the kernel
    gives 0."""
    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        keep = torch.ones((lq, lk), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep[None, None], -1e30)
    if kv_mask is not None:
        s = s.masked_fill(~(kv_mask > 0)[:, None, None, :], -1e30)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                       v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def _check_shapes(q, k, v, kv_mask):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    b, lq, h, d = q.shape
    _, lk, kvh, dk = k.shape
    if k.shape[0] != b or dk != d or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, lk):
        raise ValueError(f"kv_mask must be ({b}, {lk}), got {tuple(kv_mask.shape)}")


def _check_kernel_inputs(q, named: tuple) -> None:
    """What both kernels take: head dim 64 or 128, bf16 or float32, every
    tensor of q's dtype on its device, contiguous and 16-byte aligned."""
    d = q.shape[-1]
    if d not in (64, 128):
        raise ValueError(f"flash_attention kernel takes head dim 64 or 128, got {d}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention kernel takes bf16 or f32, got {q.dtype}")
    for name, x in named:
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _kernel_mask(kv_mask, device):
    if kv_mask is None:
        return None
    return kv_mask.to(device=device, dtype=torch.float32).contiguous()


def _flash_forward(q, k, v, kv_mask, causal, return_lse):
    _check_shapes(q, k, v, kv_mask)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, kv_mask, causal, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check_kernel_inputs(q, (("q", q), ("k", k), ("v", v)))
    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    mask = _kernel_mask(kv_mask, q.device)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    FLASH.launch("flash_attn_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), b, lq, lk, h, kvh, d,
                 int(causal), int(q.dtype == torch.bfloat16),
                 1.0 / math.sqrt(d), stream)
    return (out, lse) if return_lse else out


def flash_attention_bwd_ref(q, k, v, kv_mask, out, lse, do, causal: bool = False):
    """Plain backward → (dq, dk, dv), with the JAX kernels' arithmetic:
    P = exp(S·scale − LSE) recomputed, 0 where a key is masked; Δ =
    rowsum(dO ⊙ O); dS = P ⊙ (dO·Vᵀ − Δ); for bf16 inputs P and dS are
    rounded to bf16 before their products, as the JAX kernels feed the
    MXU; dK and dV summed over each GQA group of H/KVH query heads."""
    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    ok = torch.ones((1, 1, lq, lk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & torch.ones((lq, lk), dtype=torch.bool, device=q.device).tril()
    if kv_mask is not None:
        ok = ok & (kv_mask > 0)[:, None, None, :]
    p = torch.where(ok, torch.exp(s - lse.float()[..., None]), 0.0)
    delta = (gf * out.float()).sum(-1).transpose(1, 2)  # (B, H, Lq)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - delta[..., None])
    if q.dtype == torch.bfloat16:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    if rep > 1:  # query heads are KV-head-major: h = kv * rep + r
        dk = dk.reshape(b, lk, kvh, rep, d).sum(dim=3)
        dv = dv.reshape(b, lk, kvh, rep, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, kv_mask, out, lse, do, causal: bool = False):
    """Backward of `flash_attention` → (dq, dk, dv) in the inputs' dtype,
    from the forward's output and LSE (B, H, Lq) float32 and the output's
    gradient ``do``. Δ = rowsum(dO ⊙ O) is a torch reduction before the
    launch, as JAX computes it outside its kernels."""
    _check_shapes(q, k, v, kv_mask)
    b, lq, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    if out.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != (b, h, lq):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, kv_mask, out, lse, do, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not {q.device}")
    _check_kernel_inputs(q, (("q", q), ("k", k), ("v", v), ("out", out), ("do", do)))
    if lse.dtype != torch.float32 or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("lse must be contiguous float32 on q's device")
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    mask = _kernel_mask(kv_mask, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    FLASH_BWD.launch("flash_attn_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     None if mask is None else mask.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(), b, lq, lk, h, kvh, d, int(causal),
                     int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d), stream)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention (the JAX ``custom_vjp``, l.1116-1142):
    the forward (kernel 6 with the LSE) saves (q, k, v, mask, out, lse), the
    backward runs kernel 7. ``kv_mask`` and ``causal`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal):
        out, lse = _flash_forward(q, k, v, kv_mask, causal, True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, out, lse, g.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_mask: torch.Tensor | None = None, causal: bool = False,
                    return_lse: bool = False):
    """Fused attention → (B, Lq, H, D) in q's dtype (and the LSE if asked).
    Differentiable in q, k and v through `FlashAttentionFn`; the LSE is not
    (asking for it under grad raises)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if return_lse:
            raise ValueError("flash_attention: the LSE has no gradient; "
                             "ask for it under torch.no_grad()")
        return FlashAttentionFn.apply(q, k, v, kv_mask, causal)
    return _flash_forward(q, k, v, kv_mask, causal, return_lse)
