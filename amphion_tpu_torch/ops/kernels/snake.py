"""Snake activation: kernel 1 (`csrc/snake.cu`), forward and backward, and
their plain versions.

Port of `snake_pallas` (amphion_tpu/ops/pallas_kernels.py:40-121), a custom
VJP: the forward ``x + sin²(αx)/(α+1e-9)`` and the backward
``dx = g·(1 + sin 2αx)``, ``dα = Σ_(B,T) g·(x·sin 2αx/(α+1e-9) −
sin²αx/(α+1e-9)²)``. The backward is JAX's formula, not autograd of the
forward (which differs in the 1e-9 terms). x (B, T, C) channels last in
float32 or bf16, α (C,) float32; arithmetic in float32.

`snake` and `snake_bwd` launch the kernels on CUDA tensors and run
`snake_ref` / `snake_bwd_ref` on CPU tensors; `SnakeFn` is the
differentiable function over the two (`Snake(use_pallas=True)`). The
kernel's launches count under the tags ``fwd`` and ``bwd``.
"""

from __future__ import annotations

import torch

from amphion_tpu_torch.ops.kernels._build import I, Kernel, P, no_backward

SNAKE = Kernel("snake", {"snake_fwd": [P, P, P, I, I, I, P],
                         "snake_bwd": [P, P, P, P, P, P, I, I, I, P],
                         "snake_rows_per_block": []})


def snake_ref(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Plain forward: ``x + sin²(αx)/(α+1e-9)`` in float32, out in x's dtype."""
    a, xf = alpha.float(), x.float()
    s = torch.sin(a * xf)
    return (xf + s * s / (a + 1e-9)).to(x.dtype)


def snake_bwd_ref(x: torch.Tensor, alpha: torch.Tensor,
                  g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain backward: (dx in x's dtype, dα float32 summed over B and T)."""
    a, xf, gf = alpha.float(), x.float(), g.float()
    s2 = torch.sin(2.0 * a * xf)
    dx = (gf * (1.0 + s2)).to(x.dtype)
    s = torch.sin(a * xf)
    ae = a + 1e-9
    dalpha = (gf * (xf * s2 / ae - s * s / (ae * ae))).sum(dim=(0, 1))
    return dx, dalpha


def _check(x: torch.Tensor, alpha: torch.Tensor, *others: torch.Tensor) -> None:
    if x.ndim != 3 or x.numel() == 0 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"snake takes a nonempty x (B, T, C) float32 or bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if alpha.shape != (x.shape[2],) or alpha.dtype != torch.float32:
        raise ValueError(f"snake takes alpha ({x.shape[2]},) float32, got "
                         f"{tuple(alpha.shape)} {alpha.dtype}")
    for t in others:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"snake's gradient must match x: {tuple(t.shape)} {t.dtype}")
    for t in (x, alpha, *others):
        if t.device != x.device:
            raise ValueError("snake's tensors must lie on one device")
        if not t.is_contiguous():
            raise ValueError("snake takes contiguous tensors")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"snake runs on cuda or cpu, not {x.device}")


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Forward: kernel 1 on a CUDA tensor, `snake_ref` on a CPU tensor."""
    _check(x, alpha)
    if x.device.type == "cpu":
        return snake_ref(x, alpha)
    no_backward("snake", x, alpha)
    out = torch.empty_like(x)
    b, t, c = x.shape
    SNAKE.launch("snake_fwd", x.data_ptr(), alpha.data_ptr(), out.data_ptr(), b * t, c,
                 int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream(x.device).cuda_stream, tag="fwd")
    return out


def snake_bwd(x: torch.Tensor, alpha: torch.Tensor,
              g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward → (dx, dα): kernel 1's backward on CUDA tensors (dx and
    per-block dα partials in one pass, then a fixed-order sum of the
    partials), `snake_bwd_ref` on CPU tensors."""
    _check(x, alpha, g)
    if x.device.type == "cpu":
        return snake_bwd_ref(x, alpha, g)
    no_backward("snake_bwd", x, alpha, g)
    b, t, c = x.shape
    rows = b * t
    per_block = SNAKE.lib().snake_rows_per_block()
    dx = torch.empty_like(x)
    partial = torch.empty((-(-rows // per_block), c), dtype=torch.float32, device=x.device)
    dalpha = torch.empty((c,), dtype=torch.float32, device=x.device)
    SNAKE.launch("snake_bwd", x.data_ptr(), alpha.data_ptr(), g.data_ptr(), dx.data_ptr(),
                 partial.data_ptr(), dalpha.data_ptr(), rows, c,
                 int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream(x.device).cuda_stream, tag="bwd")
    return dx, dalpha


class SnakeFn(torch.autograd.Function):
    """Snake with JAX's custom VJP: kernel 1's forward and backward on the
    card, their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x, alpha)
        return snake(x, alpha)

    @staticmethod
    def backward(ctx, g):
        x, alpha = ctx.saved_tensors
        dx, dalpha = snake_bwd(x, alpha, g.contiguous())
        return dx, dalpha
