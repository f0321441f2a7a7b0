"""Weight-only int8 matmul: kernel 4 (`csrc/int8_matmul.cu`) and its plain version.

Port of `int8_matmul_pallas` and `quantize_weight_int8`
(amphion_tpu/ops/pallas_kernels.py:450-526). The weight is kept in the
torch ``nn.Linear`` layout, ``w_q`` (N, K) int8 with one float32 scale per
output column ``scale`` (N,), so ``w ≈ w_q * scale[:, None]``; the JAX
kernel's ``kernel_q`` is its transpose. The product rounds x to bf16,
multiplies by the int8 values (exact in bf16), sums over K in float32 and
applies the scale once, after the full K sum:

    out = (bf16(x) @ w_q.T) * scale        (M, N) float32 or bf16

On a CUDA tensor `int8_matmul` launches the kernel; on a CPU tensor it runs
`int8_matmul_ref`.
"""

from __future__ import annotations

import torch

from amphion_tpu_torch.ops.kernels._build import I, Kernel, P, no_backward

GEMV_MAX_M = 8  # rows of x up to which the kernels take their GEMV path (csrc/quant_common.cuh)
INT8_MM = Kernel("int8_matmul", {"int8_matmul": [P, P, P, P, I, I, I, I, I, P, P]})


def quantize_weight_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of a (N, K) weight →
    (w_q int8 (N, K), scale float32 (N,)).

    Mirrors the JAX decode path, which quantizes under ``jit`` from weights
    cast to bf16, where XLA turns ``/ 127.0`` into a float32 multiply by
    ``float32(1 / 127)``: the scale is ``max(amax, 1e-8) * float32(1/127)``
    in float32; the integers divide w by that scale rounded to w's dtype,
    round the quotient to w's dtype, then round half to even.
    """
    amax = torch.clamp(w.abs().amax(dim=1), min=1e-8)
    scale = amax.float() * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    w_q = torch.round(w / scale.to(w.dtype)[:, None])
    return torch.clamp(w_q, -127, 127).to(torch.int8), scale


def int8_matmul_ref(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: ``(bf16(x) @ w_q.T) * scale`` with a float32 sum."""
    out = (x.to(torch.bfloat16).float() @ w_q.float().T) * scale.float()
    return out.to(out_dtype)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (M, K) float32 or bf16 @ int8 w_q (N, K) with scale (N,) →
    (M, N) in ``out_dtype`` (float32 or bf16). M ≤ 8 takes the kernel's
    GEMV path, larger M its TMA-fed wgmma GEMM (launches counted under the
    tag ``"gemm"``), which reads bf16 x: float32 x is rounded into a bf16
    scratch first, inside the same call."""
    if x.ndim != 2 or w_q.ndim != 2 or x.shape[1] != w_q.shape[1]:
        raise ValueError(f"int8_matmul shapes x {tuple(x.shape)} w_q {tuple(w_q.shape)}")
    m, k = x.shape
    n = w_q.shape[0]
    if w_q.dtype != torch.int8 or tuple(scale.shape) != (n,):
        raise ValueError(f"int8_matmul takes int8 w_q (N, K) and scale (N,), got "
                         f"{w_q.dtype} {tuple(w_q.shape)}, scale {tuple(scale.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_matmul writes float32 or bf16, not {out_dtype}")
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w_q, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {x.device}")
    no_backward("int8_matmul", x, scale)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_matmul takes float32 or bf16 x, got {x.dtype}")
    if k % 64:
        raise ValueError(f"int8_matmul kernel needs K % 64 == 0, got K={k}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel reads x 16 bytes at a time
        x = x.clone()
    for name, t in (("w_q", w_q), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, got {scale.dtype}")
    if w_q.data_ptr() % 16:  # the GEMM's TMA needs a 16-byte-aligned base
        raise ValueError("w_q must be 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    gemm = m > GEMV_MAX_M
    xs = (torch.empty((m, k), dtype=torch.bfloat16, device=x.device)
          if gemm and x.dtype == torch.float32 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    INT8_MM.launch("int8_matmul", x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                   out.data_ptr(), m, n, k, int(x.dtype == torch.bfloat16),
                   int(out_dtype == torch.bfloat16), None if xs is None else xs.data_ptr(),
                   stream, tag="gemm" if gemm else None)
    return out
