"""RMSNorm of the AR decoder's cached path: `csrc/rms_norm.cu` and its plain
version.

Replaces no Pallas kernel (JAX computes `RMSNorm` in XLA,
amphion_tpu/modules/llama.py:119-132). The kernel sums each row's squares
in one fixed order, one block a row, so a row's result does not depend on
how many rows the call holds, which PyTorch's mean does not promise:

    out = (x * rsqrt(mean(float32(x)²) + eps) * g).to(x.dtype)

On a CUDA tensor `rms_norm` launches the kernel; on a CPU tensor it runs
`rms_norm_ref`.
"""

from __future__ import annotations

import torch

from amphion_tpu_torch.ops.kernels._build import Fl, I, Kernel, P, no_backward

RMS_NORM = Kernel("rms_norm", {"rms_norm": [P, P, P, I, I, Fl, I, P]})


def rms_norm_ref(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version: the float32 mean of squares over the last axis."""
    var = x.float().pow(2).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * g).to(x.dtype)


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """x (..., D) float32 or bf16, g (D,) of x's dtype → x's shape and dtype."""
    d = x.shape[-1]
    if g.shape != (d,):
        raise ValueError(f"rms_norm gain {tuple(g.shape)} for x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return rms_norm_ref(x, g, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cuda or cpu, not {x.device}")
    no_backward("rms_norm", x, g)
    if x.dtype not in (torch.float32, torch.bfloat16) or g.dtype != x.dtype:
        raise ValueError(f"rms_norm takes float32 or bf16 x and a gain of its dtype, got "
                         f"{x.dtype} and {g.dtype}")
    if g.device != x.device or not g.is_contiguous():
        raise ValueError(f"the gain must be contiguous on {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    RMS_NORM.launch("rms_norm", x.data_ptr(), g.data_ptr(), out.data_ptr(), rows, d, eps,
                    int(x.dtype == torch.bfloat16),
                    torch.cuda.current_stream(x.device).cuda_stream)
    return out
