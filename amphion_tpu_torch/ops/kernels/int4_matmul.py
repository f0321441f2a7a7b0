"""Weight-only int4 matmul with an optional RMSNorm prologue: kernel 5
(`csrc/int4_matmul.cu`) and its plain version.

Port of `int4_matmul_pallas`, `_int4_matmul_rms_kernel` and
`quantize_weight_int4` (amphion_tpu/ops/pallas_kernels.py:534-694).

Storage, in the torch ``nn.Linear`` orientation: ``w_p`` (N, K/2) uint8
holds two int4 values per byte packed **along K**: byte j of row n holds
k = 2j in its low nibble and k = 2j + 1 in its high nibble, each a 4-bit
two's-complement value in [-7, 7]. ``scale`` (K/group, N) float32 keeps
JAX's layout: one scale per (group of ``group`` rows of K, output column).
The product rounds x to bf16, multiplies by the int4 values (exact in bf16),
sums each group in float32 and applies that group's scale to the group's
partial sum (never to the weight), adding the groups in float32:

    out[m, n] = Σ_g (Σ_{k in g} bf16(x[m, k]) · w[n, k]) · scale[g, n]

With ``rms_scale`` (K,) the rows of x are first normalised,
``bf16(x · rsqrt(mean(x²) + eps) · rms_scale)``, as the block's RMSNorm
would before the projection.

On a CUDA tensor `int4_matmul` launches the kernel; on a CPU tensor it runs
`int4_matmul_ref`.
"""

from __future__ import annotations

import torch

from amphion_tpu_torch.ops.kernels._build import Fl, I, Kernel, P, no_backward
from amphion_tpu_torch.ops.kernels.int8_matmul import GEMV_MAX_M

INT4_MM = Kernel("int4_matmul",
                 {"int4_matmul": [P, P, P, P, P, I, I, I, I, I, I, Fl, P, P]})


def quantize_weight_int4(w: torch.Tensor, group: int = 128
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric int4 quantization of a (N, K) weight →
    (w_int int8 (N, K) holding values in [-7, 7], scale float32 (K/group, N)).

    As the jitted JAX quantizer: in float32 from the (possibly bf16) weight,
    each group of ``group`` consecutive K rows of a column gets the scale
    ``max(max|w|, 1e-8) * float32(1/7)`` (XLA's form of ``/ 7.0``)."""
    n, k = w.shape
    if k % group:
        raise ValueError(f"K={k} is not a multiple of group={group}")
    wg = w.float().reshape(n, k // group, group)
    scale = (torch.clamp(wg.abs().amax(dim=2), min=1e-8)
             * torch.tensor(1.0 / 7.0, dtype=torch.float32))  # (N, K/g)
    q = torch.clamp(torch.round(wg / scale[:, :, None]), -7, 7)
    return q.reshape(n, k).to(torch.int8), scale.T.contiguous()


def pack_int4(w_int: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 values in [-8, 7] → (N, K/2) uint8, two per byte along K."""
    if w_int.shape[1] % 2:
        raise ValueError(f"int4 packing needs an even K, got {w_int.shape[1]}")
    u = (w_int.to(torch.int16) & 0xF).to(torch.uint8)
    return (u[:, 0::2] | (u[:, 1::2] << 4)).contiguous()


def unpack_int4(w_p: torch.Tensor) -> torch.Tensor:
    """(N, K/2) uint8 → (N, K) int8, the inverse of `pack_int4`."""
    b = w_p.to(torch.int16)
    lo, hi = b & 0xF, (b >> 4) & 0xF
    both = torch.stack([lo, hi], dim=-1).reshape(w_p.shape[0], -1)
    return torch.where(both >= 8, both - 16, both).to(torch.int8)


def rms_prologue_ref(x: torch.Tensor, rms_scale: torch.Tensor, eps: float):
    """``bf16(x · rsqrt(mean(x²) + eps) · rms_scale)`` in float32."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * rms_scale.float()).to(torch.bfloat16)


def int4_matmul_ref(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor,
                    group: int, rms_scale: torch.Tensor | None = None,
                    rms_eps: float = 1e-6,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: per-group float32 partial sums, each times its scale."""
    m, k = x.shape
    xb = (rms_prologue_ref(x, rms_scale, rms_eps) if rms_scale is not None
          else x.to(torch.bfloat16)).float()
    w = unpack_int4(w_p).float()  # (N, K)
    ng = k // group
    part = torch.einsum("mgk,ngk->gmn", xb.reshape(m, ng, group),
                        w.reshape(-1, ng, group))
    out = (part * scale.float()[:, None, :]).sum(dim=0)
    return out.to(out_dtype)


def int4_matmul(x: torch.Tensor, w_p: torch.Tensor, scale: torch.Tensor,
                group: int, rms_scale: torch.Tensor | None = None,
                rms_eps: float = 1e-6,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (M, K) float32 or bf16 @ packed int4 w_p (N, K/2), scale (K/group, N)
    → (M, N) in ``out_dtype``; ``rms_scale`` (K,) adds the RMSNorm prologue.
    M ≤ 8 takes the kernel's GEMV path, larger M its TMA-fed wgmma GEMM
    (launches counted under the tag ``"gemm"``, and with the prologue under
    ``"rms_prologue"``). The GEMM reads bf16 x: a float32 x, or x to be
    normalised, is first written to a bf16 scratch inside the same call, a
    warp per whole row; the GEMV's blocks each sum their own K range and add
    the sums across their cluster."""
    if x.ndim != 2 or w_p.ndim != 2 or x.shape[1] != 2 * w_p.shape[1]:
        raise ValueError(f"int4_matmul shapes x {tuple(x.shape)} w_p {tuple(w_p.shape)}")
    m, k = x.shape
    n = w_p.shape[0]
    if w_p.dtype != torch.uint8 or k % group or tuple(scale.shape) != (k // group, n):
        raise ValueError(f"int4_matmul takes uint8 w_p (N, K/2) and scale (K/group, N); "
                         f"got {w_p.dtype} {tuple(w_p.shape)}, scale "
                         f"{tuple(scale.shape)}, group {group}")
    if rms_scale is not None and tuple(rms_scale.shape) != (k,):
        raise ValueError(f"rms_scale must be ({k},), got {tuple(rms_scale.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int4_matmul writes float32 or bf16, not {out_dtype}")
    if x.device.type == "cpu":
        return int4_matmul_ref(x, w_p, scale, group, rms_scale, rms_eps, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on cuda or cpu, not {x.device}")
    no_backward("int4_matmul", x, scale, rms_scale)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int4_matmul takes float32 or bf16 x, got {x.dtype}")
    if group != 128:
        raise ValueError(f"int4_matmul kernel takes group 128 (int4_group of K % 128 == 0), "
                         f"got {group}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel reads x 16 bytes at a time
        x = x.clone()
    g = None
    if rms_scale is not None:
        g = rms_scale.float().contiguous()
        if g.data_ptr() % 16:  # and the gain too
            g = g.clone()
    for name, t in (("w_p", w_p), ("scale", scale), ("rms_scale", g)):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, got {scale.dtype}")
    if w_p.data_ptr() % 16:  # the GEMM's TMA needs a 16-byte-aligned base
        raise ValueError("w_p must be 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    gemm = m > GEMV_MAX_M
    xs = (torch.empty((m, k), dtype=torch.bfloat16, device=x.device)
          if gemm and (g is not None or x.dtype == torch.float32) else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    INT4_MM.launch("int4_matmul", x.data_ptr(), w_p.data_ptr(), scale.data_ptr(),
                   None if g is None else g.data_ptr(), out.data_ptr(), m, n, k,
                   group, int(x.dtype == torch.bfloat16),
                   int(out_dtype == torch.bfloat16), float(rms_eps),
                   None if xs is None else xs.data_ptr(), stream,
                   tag=("gemm",) * gemm + ("rms_prologue",) * (g is not None))
    return out
