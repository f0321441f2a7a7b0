"""bf16 matrix-vector product for the AR's unquantized ``lm_head``:
`csrc/bf16_gemv.cu` and its plain version.

Replaces no Pallas kernel (JAX leaves the head to XLA,
amphion_tpu/models/vc/ar_transformer.py:175). It is the shared GEMV of the
quantized matmuls (`csrc/quant_common.cuh`) over bf16 weights, so row r of
the output does not depend on how many rows the call holds, which cuBLAS
does not promise:

    out = bf16(float32 sum of bf16(x) · w)     (M, N) from x (M, K), w (N, K)

On a CUDA tensor `bf16_linear` launches the kernel; on a CPU tensor it runs
`bf16_linear_ref`.
"""

from __future__ import annotations

import torch

from amphion_tpu_torch.ops.kernels._build import I, Kernel, P, no_backward

BF16_GEMV = Kernel("bf16_gemv", {"bf16_gemv": [P, P, P, I, I, I, P]})


def bf16_linear_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 products of the bf16 values, one bf16 rounding."""
    return (x.float() @ w.float().T).to(torch.bfloat16)


def bf16_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) bf16 @ w (N, K) bf16 → (..., N) bf16, without a bias."""
    if w.ndim != 2 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"bf16_linear shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"bf16_linear takes bf16 x and w, got {x.dtype} and {w.dtype}")
    n, k = w.shape
    lead = x.shape[:-1]
    if x.device.type == "cpu":
        return bf16_linear_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"bf16_linear runs on cuda or cpu, not {x.device}")
    no_backward("bf16_linear", x, w)
    if k % 32:
        raise ValueError(f"bf16_linear kernel needs K % 32 == 0, got K={k}")
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:  # the kernel reads x 16 bytes at a time
        x2 = x2.clone()
    if w.device != x.device or not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError(f"w must be contiguous and 16-byte aligned on {x.device}")
    out = torch.empty((x2.shape[0], n), dtype=torch.bfloat16, device=x.device)
    if x2.shape[0]:
        BF16_GEMV.launch("bf16_gemv", x2.data_ptr(), w.data_ptr(), out.data_ptr(),
                         x2.shape[0], n, k, torch.cuda.current_stream(x.device).cuda_stream)
    return out.reshape(*lead, n)
