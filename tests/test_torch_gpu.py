"""PyTorch port on the card: each CUDA kernel against its plain version.

Every test here needs a CUDA card and is marked ``gpu``; without one the
``cuda`` fixture skips it. Run them on a machine with a card with
``pytest -m gpu tests/test_torch_gpu.py``. Float32 references run with TF32
off. bf16 outputs are held to their own scale: max|err| <= 2e-2 max|ref| and
a relative Frobenius error <= 1e-2 (an absolute bound would let a dropped
tile through).
"""

import pytest
import torch

from amphion_tpu_torch.ops.kernels.flash_attention import FLASH, attention_ref, flash_attention
from amphion_tpu_torch.ops.kernels.mel import MEL
from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram, mel_spectrogram_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _close(out, ref, dtype):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4, err
    else:
        assert err <= 2e-2 * ref.abs().max().item(), err
        assert ((out - ref).norm() / ref.norm()).item() <= 1e-2


@pytest.mark.parametrize("b,t", [(1, 24000), (4, 120000), (2, 119 * 120), (1, 96000)])
def test_mel_kernel_matches_plain(cuda, b, t):
    g = torch.Generator(cuda).manual_seed(t)
    y = torch.randn((b, t), generator=g, device=cuda) * 0.3
    cfg = MelConfig()
    n = MEL.launches
    out = mel_spectrogram(y, cfg)
    torch.cuda.synchronize()
    assert MEL.launches == n + 1
    ref = mel_spectrogram_ref(y, cfg)
    assert out.shape == ref.shape == (b, 80, t // 120)
    assert (out - ref).abs().max().item() <= 1e-3


CASES = {  # b, lq, lk, h, kvh, d, causal, mask
    "slice": (4, 1536, 1536, 16, 16, 64, False, True),
    "causal": (2, 300, 300, 16, 16, 64, True, True),
    "gqa": (2, 256, 256, 16, 4, 64, True, False),
    "lq_ne_lk": (2, 200, 700, 8, 8, 64, False, True),
    "d128": (1, 333, 333, 8, 2, 128, False, True),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, lq, lk, h, kvh, d, causal, use_mask = CASES[case]
    g = torch.Generator(cuda).manual_seed(lq * lk)
    q = torch.randn((b, lq, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, lk, kvh, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, lk, kvh, d), generator=g, device=cuda).to(dtype)
    mask = None
    if use_mask:
        valid = torch.linspace(0.6, 1.0, b, device=cuda) * lk
        mask = (torch.arange(lk, device=cuda)[None] < valid[:, None]).float()
    n = FLASH.launches
    out, lse = flash_attention(q, k, v, mask, causal, return_lse=True)
    torch.cuda.synchronize()
    assert FLASH.launches == n + 1 and out.dtype == dtype
    ref, ref_lse = attention_ref(q, k, v, mask, causal, return_lse=True)
    _close(out, ref, dtype)
    assert (lse - ref_lse).abs().max().item() <= 2e-2


def test_flash_kernel_fully_masked_rows_stay_finite(cuda):
    q = torch.randn((1, 70, 2, 64), device=cuda, dtype=torch.bfloat16)
    mask = torch.zeros((1, 70), device=cuda)
    out = flash_attention(q, q, q, mask)
    assert torch.isfinite(out.float()).all() and not out.float().abs().max()


def test_flash_kernel_rejects_unsupported_head_dim(cuda):
    q = torch.randn((1, 8, 2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)


# -- weight-only int8 / int4 matmuls and int8 decode attention ----------------
# M = 4 is the Vevo AR decode batch (GEMV path), 1000 a ragged prefill and
# 6144 the flow-matching estimator (GEMM path); N 1000 and 3000 are not
# multiples of the GEMM's tile. Both paths sum in float32, in another order
# than the plain version: max|err| <= 1e-4 of max|ref| in float32 output,
# and the bf16 output within one bf16 rounding (2**-8 relative).

MM_CASES = [(4, 1280, 3840), (1, 1280, 1280), (8, 4096, 1280), (3, 1024, 1000),
            (1000, 1280, 3000), (6144, 1024, 3072), (200, 4096, 1280)]


def _mm_close(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = 1e-4 if out.dtype == torch.float32 else 2 ** -8
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("m,k,n", MM_CASES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_kernel_matches_plain(cuda, m, k, n, x_dtype):
    from amphion_tpu_torch.ops.kernels.int8_matmul import (
        INT8_MM, int8_matmul, int8_matmul_ref, quantize_weight_int8)

    g = torch.Generator(cuda).manual_seed(m * n + k)
    x = torch.randn((m, k), generator=g, device=cuda).to(x_dtype)
    w_q, scale = quantize_weight_int8(
        (torch.randn((n, k), generator=g, device=cuda) * 0.05).bfloat16())
    for out_dtype in (torch.float32, torch.bfloat16):
        launches = INT8_MM.launches
        out = int8_matmul(x, w_q, scale, out_dtype)
        torch.cuda.synchronize()
        assert INT8_MM.launches == launches + 1 and out.dtype == out_dtype
        _mm_close(out, int8_matmul_ref(x, w_q, scale, out_dtype))


@pytest.mark.parametrize("m,k,n", MM_CASES)
@pytest.mark.parametrize("rms", [False, True])
def test_int4_matmul_kernel_matches_plain(cuda, m, k, n, rms):
    from amphion_tpu_torch.ops.kernels.int4_matmul import (
        INT4_MM, int4_matmul, int4_matmul_ref, pack_int4, quantize_weight_int4)

    g = torch.Generator(cuda).manual_seed(m * n + k + rms)
    x = torch.randn((m, k), generator=g, device=cuda).bfloat16()
    w_int, scale = quantize_weight_int4(
        (torch.randn((n, k), generator=g, device=cuda) * 0.05).bfloat16(), 128)
    w_p = pack_int4(w_int)
    gain = (1 + 0.1 * torch.randn((k,), generator=g, device=cuda)) if rms else None
    for out_dtype in (torch.float32, torch.bfloat16):
        launches = INT4_MM.launches
        out = int4_matmul(x, w_p, scale, 128, gain, 1e-6, out_dtype)
        torch.cuda.synchronize()
        assert INT4_MM.launches == launches + 1 and out.dtype == out_dtype
        ref = int4_matmul_ref(x, w_p, scale, 128, gain, 1e-6, out_dtype)
        if rms:  # the prologue's bf16 rounding may flip where the sums differ
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= 2e-2 * ref.float().abs().max().item()
            assert ((out.float() - ref.float()).norm() / ref.float().norm()).item() <= 1e-3
        else:
            _mm_close(out, ref)


@pytest.mark.parametrize("b,h,s,d,lens", [(1, 20, 2200, 64, [1733]),
                                          (4, 20, 1600, 64, [1600, 1201, 256, 1]),
                                          (2, 8, 300, 128, [300, 257])])
def test_decode_attention_int8_kernel_matches_plain(cuda, b, h, s, d, lens):
    from amphion_tpu_torch.ops.kernels.decode_attention import (
        DECODE_ATTN, decode_attention_int8, decode_attention_int8_ref)

    g = torch.Generator(cuda).manual_seed(s)
    q = torch.randn((b, h, d), generator=g, device=cuda)
    ck, cv = (torch.randint(-127, 128, (b, h, s, d), generator=g, device=cuda,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, h, s), generator=g, device=cuda) * 0.02 for _ in range(2))
    valid = torch.tensor(lens, device=cuda, dtype=torch.int32)
    launches = DECODE_ATTN.launches
    out = decode_attention_int8(q, ck, cv, ks, vs, valid)
    torch.cuda.synchronize()
    assert DECODE_ATTN.launches == launches + 1
    ref = decode_attention_int8_ref(q, ck, cv, ks, vs, valid)
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


# -- flash-attention backward (kernel 7) ---------------------------------------
# The Vevo trainers' shapes (FM non-causal with an all-ones mask, AR causal
# with a ragged key mask), GQA with uneven unequal lengths, Lq > Lk, and
# head dim 128. float32 gradients within 1e-4 of max|ref| (float32 sums in
# another order); bf16 within 2e-2 of max|ref| and 1e-2 relative Frobenius,
# the forward's bf16 gate. Both directions start from the kernel's own
# forward output and LSE.

BWD_CASES = {  # b, lq, lk, h, kvh, d, causal, mask ("ones", "ragged", None)
    "fm_train": (8, 256, 256, 16, 16, 64, False, "ones"),
    "ar_train": (8, 516, 516, 20, 20, 64, True, "ragged"),
    "gqa_uneven": (2, 200, 333, 8, 2, 64, False, "ragged"),
    "gqa_causal_tails": (1, 37, 53, 8, 2, 64, True, "ragged"),
    "lq_gt_lk": (1, 50, 30, 2, 1, 64, False, None),
    "d128": (2, 190, 190, 4, 2, 128, True, "ragged"),
}


def _bwd_inputs(cuda, case, dtype):
    b, lq, lk, h, kvh, d, causal, mask_kind = BWD_CASES[case]
    g = torch.Generator(cuda).manual_seed(lq * 7 + lk)
    q, do = (torch.randn((b, lq, h, d), generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, lk, kvh, d), generator=g, device=cuda).to(dtype) for _ in range(2))
    mask = None
    if mask_kind == "ones":
        mask = torch.ones((b, lk), device=cuda)
    elif mask_kind == "ragged":
        valid = torch.linspace(0.6, 1.0, b, device=cuda) * lk
        mask = (torch.arange(lk, device=cuda)[None] < valid[:, None].ceil()).float()
    return q, k, v, mask, do, causal


def _grad_close(out, ref, dtype):
    out, ref = out.float(), ref.float()
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4 * scale, (err, scale)
    else:
        assert err <= 2e-2 * scale, (err, scale)
        assert ((out - ref).norm() / ref.norm()).item() <= 1e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_kernel_matches_plain(cuda, case, dtype):
    from amphion_tpu_torch.ops.kernels.flash_attention import (
        FLASH_BWD, flash_attention_bwd, flash_attention_bwd_ref)

    q, k, v, mask, do, causal = _bwd_inputs(cuda, case, dtype)
    out, lse = flash_attention(q, k, v, mask, causal, return_lse=True)
    n = FLASH_BWD.launches
    grads = flash_attention_bwd(q, k, v, mask, out, lse, do, causal)
    torch.cuda.synchronize()
    assert FLASH_BWD.launches == n + 1
    refs = flash_attention_bwd_ref(q, k, v, mask, out, lse, do, causal)
    for got, ref, x in zip(grads, refs, (q, k, v)):
        assert got.shape == x.shape and got.dtype == dtype
        _grad_close(got, ref, dtype)
    # no atomics: a second launch gives the same bits
    again = flash_attention_bwd(q, k, v, mask, out, lse, do, causal)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("case", ["fm_train", "ar_train", "gqa_uneven"])
def test_flash_function_grads_match_float64_autograd(cuda, case):
    """The autograd Function (kernel 6 then kernel 7) in float32 against
    float64 autograd through `attention_ref`'s arithmetic, within 1e-4 of
    max|ref|."""
    import math

    q, k, v, mask, do, causal = _bwd_inputs(cuda, case, torch.float32)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves, mask, causal), leaves, do)

    q64, k64, v64 = (x.double().requires_grad_() for x in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q64, k64.repeat_interleave(rep, 2))
    s = s / math.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool, device=cuda).tril(), -1e30)
    if mask is not None:
        s = s.masked_fill(~(mask > 0)[:, None, None, :], -1e30)
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v64.repeat_interleave(rep, 2))
    refs = torch.autograd.grad(ref, (q64, k64, v64), do.double())
    for a, b in zip(got, refs):
        err, scale = (a.double() - b).abs().max().item(), b.abs().max().item()
        assert err <= 1e-4 * scale, (err, scale)


def test_flash_bwd_fully_masked_rows_get_zero_grad(cuda):
    from amphion_tpu_torch.ops.kernels.flash_attention import flash_attention_bwd

    q, k, v, do = (torch.randn((2, 70, 2, 64), device=cuda) for _ in range(4))
    mask = torch.ones((2, 70), device=cuda)
    mask[1] = 0.0
    out, lse = flash_attention(q, k, v, mask, return_lse=True)
    dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse, do)
    assert torch.isfinite(dq).all() and not dq[1].abs().max()
    assert not dk[1].abs().max() and not dv[1].abs().max()


def test_backwardless_wrappers_raise_under_grad(cuda):
    """Kernels 3, 4, 5 and 8 have no backward: under grad, with an input
    that requires grad, their wrappers raise instead of cutting the graph."""
    from amphion_tpu_torch.ops.kernels.decode_attention import decode_attention_int8
    from amphion_tpu_torch.ops.kernels.int4_matmul import (
        int4_matmul, pack_int4, quantize_weight_int4)
    from amphion_tpu_torch.ops.kernels.int8_matmul import int8_matmul, quantize_weight_int8

    w = torch.randn((256, 256), device=cuda)
    x = torch.randn((4, 256), device=cuda, requires_grad=True)
    w_q, sc = quantize_weight_int8(w)
    with pytest.raises(RuntimeError, match="no backward"):
        int8_matmul(x, w_q, sc)
    w_int, sc4 = quantize_weight_int4(w, 128)
    with pytest.raises(RuntimeError, match="no backward"):
        int4_matmul(x, pack_int4(w_int), sc4, 128)
    y = torch.randn((1, 24000), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        mel_spectrogram(y, MelConfig())
    q = torch.randn((1, 2, 64), device=cuda, requires_grad=True)
    ck = torch.zeros((1, 2, 16, 64), dtype=torch.int8, device=cuda)
    ks = torch.ones((1, 2, 16), device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention_int8(q, ck, ck, ks, ks, torch.tensor([16], device=cuda))
    with torch.no_grad():  # the same calls run without grad
        int8_matmul(x, w_q, sc)
        mel_spectrogram(y, MelConfig())


# -- kernels 1 and 2: Snake and the anti-aliased SnakeBeta ---------------------------

SNAKE_SHAPES = [(16, 320, 256), (16, 7680, 32), (3, 1000, 96), (2, 300, 8), (1, 12, 40),
                (1, 1, 5)]  # AMP shapes of the egs training batch, ragged T, T < 13


def _within_one_bf16_step(out, ref):
    o, r = out.detach().float(), ref.detach().float()
    step = torch.exp2(torch.floor(torch.log2(torch.maximum(o.abs(), r.abs()).clamp_min(1e-30))) - 7)
    assert bool(((o - r).abs() <= step).all())


def _rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SNAKE_SHAPES, ids=str)
def test_aa_snake_kernel_matches_plain(cuda, shape, dtype):
    """Kernel 2 against the plain version of the same fused arithmetic over
    the whole signal, edges included: float32 within 1e-5 of max|ref|,
    bf16 within one bf16 step of the float32 result rounded."""
    from amphion_tpu_torch.ops.kernels.aa_snake import AA_SNAKE, aa_snakebeta, aa_snakebeta_ref

    g = torch.Generator(cuda).manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g, device=cuda) * 3).to(dtype)
    alpha, beta = (torch.rand(shape[-1], generator=g, device=cuda) * 1.5 + 0.5 for _ in range(2))
    n = AA_SNAKE.launches
    out = aa_snakebeta(x, alpha, beta)
    torch.cuda.synchronize()
    assert AA_SNAKE.launches == n + 1 and out.dtype == dtype and out.shape == x.shape
    ref = aa_snakebeta_ref(x, alpha, beta)
    if dtype == torch.float32:
        assert _rel_err(out, ref) <= 1e-5
    else:
        _within_one_bf16_step(out, ref)


def test_aa_snake_function_grads_match_cpu(cuda):
    """`AASnakeBetaFn` on the card (kernel 2 forward, autograd of the
    unfused chain through cuDNN backward) against the CPU: 1e-5 / 1e-4 of
    max|ref| (sums over time in another order)."""
    from amphion_tpu_torch.ops.kernels.aa_snake import AASnakeBetaFn

    g = torch.Generator(cuda).manual_seed(7)
    x = torch.randn((2, 700, 48), generator=g, device=cuda) * 3
    alpha, beta = (torch.rand(48, generator=g, device=cuda) + 0.5 for _ in range(2))
    gout = torch.randn(x.shape, generator=g, device=cuda)
    dev = [t.clone().requires_grad_() for t in (x, alpha, beta)]
    cpu = [t.cpu().requires_grad_() for t in (x, alpha, beta)]
    y, y_cpu = AASnakeBetaFn.apply(*dev), AASnakeBetaFn.apply(*cpu)
    assert _rel_err(y.cpu(), y_cpu) <= 1e-5
    for a, b in zip(torch.autograd.grad(y, dev, gout), torch.autograd.grad(y_cpu, cpu, gout.cpu())):
        assert _rel_err(a.cpu(), b) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SNAKE_SHAPES, ids=str)
def test_snake_kernels_match_plain(cuda, shape, dtype):
    """Kernel 1 through ``Snake(use_pallas=True)``: y and dx within 1e-5 of
    max|ref| in float32 (one bf16 step in bf16), dalpha within 1e-5 of
    max|ref| and bit-equal on relaunch (no atomics)."""
    from amphion_tpu_torch.modules.activations import Snake
    from amphion_tpu_torch.ops.kernels.snake import SNAKE, snake_bwd, snake_bwd_ref, snake_ref

    g = torch.Generator(cuda).manual_seed(sum(shape) + 1)
    m = Snake(shape[-1], use_pallas=True).to(cuda)
    with torch.no_grad():
        m.alpha.copy_(torch.rand(shape[-1], generator=g, device=cuda) * 1.5 + 0.5)
    x = (torch.randn(shape, generator=g, device=cuda) * 3).to(dtype).requires_grad_()
    gout = torch.randn(shape, generator=g, device=cuda).to(dtype)
    before = dict(SNAKE.tagged)
    y = m(x)
    y.backward(gout)
    torch.cuda.synchronize()
    assert SNAKE.tagged["fwd"] == before.get("fwd", 0) + 1
    assert SNAKE.tagged["bwd"] == before.get("bwd", 0) + 1
    a = m.alpha.detach()
    ref_y = snake_ref(x.detach(), a)
    ref_dx, ref_da = snake_bwd_ref(x.detach(), a, gout)
    assert y.dtype == x.grad.dtype == dtype and m.alpha.grad.dtype == torch.float32
    if dtype == torch.float32:
        assert _rel_err(y, ref_y) <= 1e-5 and _rel_err(x.grad, ref_dx) <= 1e-5
    else:
        _within_one_bf16_step(y, ref_y)
        _within_one_bf16_step(x.grad, ref_dx)
    assert _rel_err(m.alpha.grad, ref_da) <= 1e-5
    _, da = snake_bwd(x.detach(), a, gout)
    assert torch.equal(da, m.alpha.grad)


def test_snake_wrappers_raise_under_grad(cuda):
    """The wrappers themselves have no backward: under grad they raise
    (`SnakeFn` and `AASnakeBetaFn` are the differentiable entries)."""
    from amphion_tpu_torch.ops.kernels.aa_snake import aa_snakebeta
    from amphion_tpu_torch.ops.kernels.snake import snake

    x = torch.randn((1, 16, 8), device=cuda, requires_grad=True)
    a = torch.ones(8, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        snake(x, a)
    with pytest.raises(RuntimeError, match="no backward"):
        aa_snakebeta(x, a, a)
