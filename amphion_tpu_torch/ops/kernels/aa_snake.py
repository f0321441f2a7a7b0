"""Anti-aliased SnakeBeta: kernel 2 (`csrc/aa_snake.cu`) and its plain
version.

Port of `aa_snake_pallas` / `aa_snakebeta_pallas`
(amphion_tpu/ops/pallas_kernels.py:128-309): BigVGAN's
``down2(snakebeta(up2(x)))`` in one pass, in polyphase form. The two phases
of the 2x-rate signal are 7-slot FIRs of x, the activation
``u + sin²(αu)/(β+1e-9)`` runs in float32 on each, and the decimating FIR
mixes both phases. x is edge-padded once by the 6-sample halo, where the
unfused chain (`aa_snakebeta_chain`) pads inside each resampler: the two
differ near the ends, so the kernel is held against `aa_snakebeta_ref`,
the same fused arithmetic in plain PyTorch. x (B, T, C) channels last in
float32 or bf16, α and β (C,) float32; out in x's dtype.

`aa_snakebeta` launches the kernel on a CUDA tensor and runs the plain
version on a CPU tensor. `AASnakeBetaFn` makes it differentiable with
JAX's rule (`_aa_snake_bwd`): the backward is autograd of the unfused
chain, so kernel 2 has no backward of its own. `aa_snake` is Snake's form
(β := α; the gradients of the two uses add up).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from amphion_tpu_torch.modules.anti_aliasing import (
    down_filter,
    downsample1d,
    up_filter,
    upsample1d,
)
from amphion_tpu_torch.ops.kernels._build import I, Kernel, P, no_backward

AA_SNAKE = Kernel("aa_snake", {"aa_snake_fwd": [P, P, P, P, P, I, I, I, I, P]})
AA_HALO = 6
SLOTS = 7
ZERO_SLOT = (6, 0, 0, 6)  # the zero slot of up_0, up_1, down_0, down_1 (`csrc/aa_snake.cu`)


@functools.lru_cache(maxsize=1)
def aa_polyphase_taps() -> tuple[tuple[float, ...], ...]:
    """(up_0, up_1, down_0, down_1): 7 slots each, so that

        u_p[i] = Σ_d up_p[d]·x[i + d − 3]         (u_p[i] = up2(x)[2i + p])
        z[i]   = Σ_d down_0[d]·s_0[i + d − 3] + down_1[d]·s_1[i + d − 3]

    read off the ratio-2 filters of `modules/anti_aliasing.py` (12 taps):
    up2(x)[n] = Σ_j x[j]·f_up[n + 5 − 2j] and down2(s)[i] = Σ_j
    s[2i + j − 5]·f_down[j] away from the edges."""
    f_up, f_down = up_filter(2), down_filter(2)
    k = f_up.shape[0]
    up = np.zeros((2, SLOTS), np.float32)
    down = np.zeros((2, SLOTS), np.float32)
    for p in (0, 1):
        for d in range(-3, 4):
            j = p + (k - 2) // 2 - 2 * d
            if 0 <= j < k:
                up[p, d + 3] = f_up[j]
    for j in range(k):
        rel = j - (k - 2) // 2  # offset in the 2x-rate signal from 2i
        p = rel % 2
        down[p, (rel - p) // 2 + 3] = f_down[j]
    return tuple(tuple(float(v) for v in row) for row in (*up, *down))


@functools.lru_cache(maxsize=8)
def _taps_tensor(device: torch.device) -> torch.Tensor:
    """The 28 taps as the kernel takes them; it skips slot `ZERO_SLOT[f]`
    of filter f at compile time, so any other zero pattern raises."""
    taps = aa_polyphase_taps()
    zeros = tuple(tuple(d for d, w in enumerate(row) if w == 0.0) for row in taps)
    if zeros != tuple((z,) for z in ZERO_SLOT):
        raise ValueError(f"aa_snake kernel skips slots {ZERO_SLOT}, the taps' zeros are {zeros}")
    return torch.tensor(taps, dtype=torch.float32, device=device).reshape(-1)


def aa_snakebeta_ref(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused arithmetic: one edge pad of x by the
    halo, the two up-phase FIRs, SnakeBeta in float32, the decimating FIR
    over both phases, zero taps skipped and sums in slot order (as the JAX
    kernel and `csrc/aa_snake.cu` run them); out in x's dtype."""
    t = x.shape[1]
    h = AA_HALO
    xp = F.pad(x.float().transpose(1, 2), (h, h), mode="replicate").transpose(1, 2)
    a, be = alpha.float(), beta.float() + 1e-9
    up0, up1, down0, down1 = aa_polyphase_taps()

    def fir(taps, buf, n):
        acc = None
        for d, w in enumerate(taps):
            if w != 0.0:
                term = w * buf[:, d: d + n]
                acc = term if acc is None else acc + term
        return acc

    def act(u):
        s = torch.sin(a * u)
        return u + s * s / be

    s0, s1 = act(fir(up0, xp, t + 6)), act(fir(up1, xp, t + 6))
    return (fir(down0, s0, t) + fir(down1, s1, t)).to(x.dtype)


def aa_snakebeta_chain(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The unfused chain ``downsample1d(snakebeta(upsample1d(x)))`` whose
    autograd is the backward (JAX `_aa_snake_bwd`)."""
    s = upsample1d(x, 2)
    s = s + torch.sin(alpha * s) ** 2 / (beta + 1e-9)
    return downsample1d(s, 2)


def _check(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> None:
    if x.ndim != 3 or x.numel() == 0 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"aa_snakebeta takes a nonempty x (B, T, C) float32 or bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    for name, t in (("alpha", alpha), ("beta", beta)):
        if t.shape != (x.shape[2],) or t.dtype != torch.float32:
            raise ValueError(f"aa_snakebeta takes {name} ({x.shape[2]},) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (x, alpha, beta):
        if t.device != x.device:
            raise ValueError("aa_snakebeta's tensors must lie on one device")
        if not t.is_contiguous():
            raise ValueError("aa_snakebeta takes contiguous tensors")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"aa_snakebeta runs on cuda or cpu, not {x.device}")


def aa_snakebeta(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """x (B, T, C) → (B, T, C): kernel 2 on a CUDA tensor, `aa_snakebeta_ref`
    on a CPU tensor. Not differentiable on the card: use `AASnakeBetaFn`."""
    _check(x, alpha, beta)
    if x.device.type == "cpu":
        return aa_snakebeta_ref(x, alpha, beta)
    no_backward("aa_snakebeta", x, alpha, beta)
    out = torch.empty_like(x)
    b, t, c = x.shape
    AA_SNAKE.launch("aa_snake_fwd", x.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
                    _taps_tensor(x.device).data_ptr(), out.data_ptr(), b, t, c,
                    int(x.dtype == torch.bfloat16),
                    torch.cuda.current_stream(x.device).cuda_stream)
    return out


class AASnakeBetaFn(torch.autograd.Function):
    """Fused anti-aliased SnakeBeta with JAX's VJP: the forward is
    `aa_snakebeta`, the backward autograd of `aa_snakebeta_chain`."""

    @staticmethod
    def forward(ctx, x, alpha, beta):
        ctx.save_for_backward(x, alpha, beta)
        return aa_snakebeta(x, alpha, beta)

    @staticmethod
    def backward(ctx, g):
        x, alpha, beta = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, alpha, beta)]
            y = aa_snakebeta_chain(*leaves)
        return torch.autograd.grad(y, leaves, g.to(y.dtype))


def aa_snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Anti-aliased Snake: SnakeBeta with β := α."""
    return AASnakeBetaFn.apply(x, alpha, alpha)
