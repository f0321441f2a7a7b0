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


# Kernel 3 at the configurations the repo has and at its n_fft limits: the
# base mel (config/base.json), bigvgan_large's (egs/vocoder/gan/bigvgan_large),
# n_fft 256 and 2048. Lengths: a frame count that is not a multiple of the
# kernel's 4-frame tile at B = 4, and T one sample above the reflect pad.
MEL_CONFIGS = {
    "base": MelConfig(),
    "bigvgan_large": MelConfig(n_fft=1024, win_size=1024, hop_size=256, n_mel=100),
    "n_fft_256": MelConfig(sample_rate=16000, n_fft=256, win_size=200, hop_size=80, n_mel=40,
                           fmax=8000.0),
    "n_fft_2048": MelConfig(n_fft=2048, win_size=1200, hop_size=300, n_mel=128),
}
MEL_CASES = [("base", 4, 101 * 120 + 37), ("base", 1, 453), ("bigvgan_large", 4, 91 * 256 + 5),
             ("bigvgan_large", 1, 385), ("n_fft_256", 2, 16000 + 11), ("n_fft_2048", 2, 48000 + 7)]


@pytest.mark.parametrize("name,b,t", MEL_CASES)
def test_mel_kernel_against_plain_and_float64(cuda, name, b, t):
    """Kernel 3 (an FFT) within 1e-3 of the plain float32 version (a direct
    DFT) and of the same arithmetic in float64 on the log-mel, one launch a
    call, and bit-equal on relaunch."""
    from amphion_tpu_torch.ops.kernels.mel import log_mel_f64
    from amphion_tpu_torch.ops.mel import _fbank

    cfg = MEL_CONFIGS[name]
    g = torch.Generator(cuda).manual_seed(t)
    y = torch.randn((b, t), generator=g, device=cuda) * 0.3
    n = MEL.launches
    out = mel_spectrogram(y, cfg)
    again = mel_spectrogram(y, cfg)
    torch.cuda.synchronize()
    assert MEL.launches == n + 2
    ref = mel_spectrogram_ref(y, cfg)
    f64 = log_mel_f64(y, _fbank(cfg, cuda), cfg.n_fft, cfg.hop_size, cfg.win_size, cfg.clip_val)
    assert out.shape == ref.shape == (b, cfg.n_mel, t // cfg.hop_size)
    assert (out - ref).abs().max().item() <= 1e-3
    assert (out.double() - f64).abs().max().item() <= 1e-3
    assert torch.equal(out, again)


@pytest.mark.parametrize("n_fft", [1000, 128, 4096])
def test_mel_kernel_rejects_unsupported_n_fft(cuda, n_fft):
    """Kernel 3 takes n_fft a power of two from 256 to 2048; on the card the
    wrapper names the limit for any other (the plain version takes any)."""
    cfg = MelConfig(n_fft=n_fft, win_size=min(480, n_fft), hop_size=n_fft // 4)
    y = torch.randn((1, 24000), device=cuda)
    with pytest.raises(ValueError, match="power of two from 256 to 2048"):
        mel_spectrogram(y, cfg)


# The tiles' edges: the bf16 forward takes 128 query rows and 64 keys a
# tile, the float32 kernels 64 rows and 32 keys; (129, 193) is one past a
# tile on both sides, "short_keys" has fewer keys than one tile, "d128" and
# "d128_edges" take two 128-byte swizzle boxes per bf16 row, and
# "dead_row" masks every key of batch row 1 (its output is 0).
CASES = {  # b, lq, lk, h, kvh, d, causal, mask (False, True = ragged, "dead_row")
    "slice": (4, 1536, 1536, 16, 16, 64, False, True),
    "causal": (2, 300, 300, 16, 16, 64, True, True),
    "gqa": (2, 256, 256, 16, 4, 64, True, False),
    "lq_ne_lk": (2, 200, 700, 8, 8, 64, False, True),
    "d128": (1, 333, 333, 8, 2, 128, False, True),
    "tile_edges": (2, 129, 193, 8, 8, 64, False, True),
    "tile_edges_causal": (1, 193, 129, 4, 2, 64, True, True),
    "short_keys": (2, 70, 20, 4, 4, 64, False, True),
    "gqa16_4_ragged": (2, 300, 300, 16, 4, 64, False, True),
    "d128_edges": (1, 129, 193, 4, 2, 128, True, True),
    "dead_row": (3, 150, 150, 8, 4, 64, False, "dead_row"),
}


def _ragged_mask(cuda, b, lk, kind):
    valid = torch.linspace(0.6, 1.0, b, device=cuda) * lk
    mask = (torch.arange(lk, device=cuda)[None] < valid[:, None].ceil()).float()
    if kind == "dead_row":
        mask[1] = 0.0
    return mask


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, lq, lk, h, kvh, d, causal, use_mask = CASES[case]
    g = torch.Generator(cuda).manual_seed(lq * lk)
    q = torch.randn((b, lq, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, lk, kvh, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, lk, kvh, d), generator=g, device=cuda).to(dtype)
    mask = _ragged_mask(cuda, b, lk, use_mask) if use_mask else None
    n = FLASH.launches
    out, lse = flash_attention(q, k, v, mask, causal, return_lse=True)
    torch.cuda.synchronize()
    assert FLASH.launches == n + 1 and out.dtype == dtype
    ref, ref_lse = attention_ref(q, k, v, mask, causal, return_lse=True)
    # a batch row with every key masked gives 0 (the plain version attends
    # uniformly there); the others are held to the plain version
    live = torch.ones(b, dtype=torch.bool, device=cuda) if mask is None else mask.amax(1) > 0
    if not live.all():
        assert not out[~live].float().abs().max().item()
    _close(out[live], ref[live], dtype)
    assert (lse[live] - ref_lse[live]).abs().max().item() <= 2e-2
    # no atomics: a second launch gives the same bits
    again, again_lse = flash_attention(q, k, v, mask, causal, return_lse=True)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


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
# M = 4 is the Vevo AR decode batch (GEMV path: qkv, o, gateup and down of
# the AR decoder), 1000 a ragged prefill and 6144 the flow-matching
# estimator (GEMM path); N 1000 and 3000 are not multiples of the GEMM's
# 128-column tile. (2, 2176, 1000) splits K unevenly between the blocks of a
# GEMV cluster (34 int8 chunks over 4 blocks, 17 int4 groups over 3) and
# ends in a partial 16-column tile. The GEMM rows: M = 9 (the smallest
# GEMM), 127 and 129 (one row either side of a 128-row tile), the voice
# batch's AR prefill (2316 rows, qkv) and FM (5120 rows, qkv), with K 4096
# at 129 rows. Both paths sum in float32, in another order than the plain
# version: max|err| <= 1e-4 of max|ref| in float32 output, and the bf16
# output within one bf16 rounding (2**-8 relative).

MM_CASES = [(4, 1280, 3840), (1, 1280, 1280), (8, 4096, 1280), (3, 1024, 1000),
            (1000, 1280, 3000), (6144, 1024, 3072), (200, 4096, 1280),
            (4, 1280, 8192), (4, 4096, 1280), (2, 2176, 1000),
            (9, 1280, 1280), (127, 1024, 1000), (129, 4096, 3000), (2316, 1280, 3840),
            (5120, 1024, 3072)]


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


# The GEMV's two properties the decode relies on: a relaunch gives the same
# bits, and row r of the output does not depend on M or on the other rows
# (row r at M = 1 and M = 4 equals row r at M = 8, bit for bit), with and
# without int4's RMSNorm prologue, in float32 and bf16 output.
GEMV_SHAPES = [(1280, 3840), (1280, 1280), (1280, 8192), (4096, 1280), (2176, 1000)]


def _quant_weights(cuda, kind, k, n, seed):
    from amphion_tpu_torch.ops.kernels.int4_matmul import (
        int4_matmul, pack_int4, quantize_weight_int4)
    from amphion_tpu_torch.ops.kernels.int8_matmul import int8_matmul, quantize_weight_int8

    g = torch.Generator(cuda).manual_seed(seed)
    w = (torch.randn((n, k), generator=g, device=cuda) * 0.05).bfloat16()
    x = torch.randn((8, k), generator=g, device=cuda).bfloat16()
    if kind == "int8":
        w_q, scale = quantize_weight_int8(w)
        return x, lambda xx, dt: int8_matmul(xx, w_q, scale, dt)
    w_int, scale = quantize_weight_int4(w, 128)
    w_p = pack_int4(w_int)
    gain = (1 + 0.1 * torch.randn((k,), generator=g, device=cuda)) if kind == "int4_rms" else None
    return x, lambda xx, dt: int4_matmul(xx, w_p, scale, 128, gain, 1e-6, dt)


@pytest.mark.parametrize("k,n", GEMV_SHAPES)
@pytest.mark.parametrize("kind", ["int8", "int4", "int4_rms"])
def test_quant_gemv_relaunch_is_bit_equal(cuda, kind, k, n):
    x, mm = _quant_weights(cuda, kind, k, n, k + n)
    for m in (1, 4, 8):
        for dt in (torch.float32, torch.bfloat16):
            first = mm(x[:m], dt)
            again = [mm(x[:m], dt) for _ in range(3)]
            torch.cuda.synchronize()
            assert all(torch.equal(first, a) for a in again), (m, dt)


@pytest.mark.parametrize("k,n", GEMV_SHAPES)
@pytest.mark.parametrize("kind", ["int8", "int4", "int4_rms"])
def test_quant_gemv_rows_do_not_depend_on_m(cuda, kind, k, n):
    x, mm = _quant_weights(cuda, kind, k, n, 3 * k + n)
    for dt in (torch.float32, torch.bfloat16):
        full = mm(x, dt)
        assert torch.equal(mm(x[:4], dt), full[:4]), dt
        for r in range(8):
            assert torch.equal(mm(x[r:r + 1], dt)[0], full[r]), (r, dt)


@pytest.mark.parametrize("m,k,n", [(129, 1280, 1000), (2316, 4096, 1280)])
def test_int4_gemm_float32_x_matches_plain(cuda, m, k, n):
    """float32 x on the GEMM path, rounded to bf16 into the scratch first."""
    from amphion_tpu_torch.ops.kernels.int4_matmul import (
        INT4_MM, int4_matmul, int4_matmul_ref, pack_int4, quantize_weight_int4)

    g = torch.Generator(cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda)
    w_int, scale = quantize_weight_int4(
        (torch.randn((n, k), generator=g, device=cuda) * 0.05).bfloat16(), 128)
    w_p = pack_int4(w_int)
    for out_dtype in (torch.float32, torch.bfloat16):
        gemm = INT4_MM.tagged.get("gemm", 0)
        out = int4_matmul(x, w_p, scale, 128, None, 1e-6, out_dtype)
        torch.cuda.synchronize()
        assert INT4_MM.tagged["gemm"] == gemm + 1
        _mm_close(out, int4_matmul_ref(x, w_p, scale, 128, None, 1e-6, out_dtype))


# The GEMM path (M > 8): a relaunch gives the same bits, with and without
# int4's prologue, from float32 and bf16 x, in float32 and bf16 output.
GEMM_SHAPES = [(129, 1280, 3840), (2316, 1280, 1000), (5120, 4096, 1280)]


def _quant_gemm(cuda, kind, k, n, m, seed):
    from amphion_tpu_torch.ops.kernels.int4_matmul import (
        int4_matmul, pack_int4, quantize_weight_int4)
    from amphion_tpu_torch.ops.kernels.int8_matmul import int8_matmul, quantize_weight_int8

    g = torch.Generator(cuda).manual_seed(seed)
    w = (torch.randn((n, k), generator=g, device=cuda) * 0.05).bfloat16()
    x = torch.randn((m, k), generator=g, device=cuda)
    if kind == "int8":
        w_q, scale = quantize_weight_int8(w)
        return x, lambda xx, dt: int8_matmul(xx, w_q, scale, dt)
    w_int, scale = quantize_weight_int4(w, 128)
    w_p = pack_int4(w_int)
    gain = (1 + 0.1 * torch.randn((k,), generator=g, device=cuda)) if kind == "int4_rms" else None
    return x, lambda xx, dt: int4_matmul(xx, w_p, scale, 128, gain, 1e-6, dt)


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
@pytest.mark.parametrize("kind", ["int8", "int4", "int4_rms"])
def test_quant_gemm_relaunch_is_bit_equal(cuda, kind, m, k, n):
    x, mm = _quant_gemm(cuda, kind, k, n, m, m + k + n)
    for xx in (x, x.bfloat16()):
        for dt in (torch.float32, torch.bfloat16):
            first = mm(xx, dt)
            again = [mm(xx, dt) for _ in range(2)]
            torch.cuda.synchronize()
            assert all(torch.equal(first, a) for a in again), (xx.dtype, dt)


# Row r of the GEMM's output at M = 129 equals row r at M = 2316, bit for
# bit: each output's K order is fixed by its tile, whatever the other rows.
@pytest.mark.parametrize("k,n", [(1280, 3840), (4096, 1000)])
@pytest.mark.parametrize("kind", ["int8", "int4", "int4_rms"])
def test_quant_gemm_rows_do_not_depend_on_m(cuda, kind, k, n):
    x, mm = _quant_gemm(cuda, kind, k, n, 2316, 5 * k + n)
    for xx in (x, x.bfloat16()):
        for dt in (torch.float32, torch.bfloat16):
            assert torch.equal(mm(xx[:129], dt), mm(xx, dt)[:129]), (xx.dtype, dt)


# The fused decode's cache (S = 1272) at valid_len 1, 3 (not a whole group
# of 4), 40 (the last ranks' shares empty) and S; shares longer than one
# chunk of the kernel (1733, and 1999 at D = 128); S not a multiple of 4.
@pytest.mark.parametrize("b,h,s,d,lens", [(1, 20, 2200, 64, [1733]),
                                          (4, 20, 1600, 64, [1600, 1201, 256, 1]),
                                          (2, 8, 300, 128, [300, 257]),
                                          (1, 20, 1272, 64, [1]),
                                          (1, 20, 1272, 64, [3]),
                                          (1, 20, 1272, 64, [40]),
                                          (1, 20, 1272, 64, [1272]),
                                          (1, 4, 2000, 128, [1999]),
                                          (2, 3, 301, 64, [301, 150])])
def test_decode_attention_int8_kernel_matches_plain(cuda, b, h, s, d, lens):
    """Kernel 8 within 1e-4 of max|ref| (float32 sums in another order), one
    launch per call, and bit-equal when relaunched."""
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
    assert torch.equal(decode_attention_int8(q, ck, cv, ks, vs, valid), out)


# -- flash-attention backward (kernel 7) ---------------------------------------
# The Vevo trainers' shapes (FM non-causal with an all-ones mask, AR causal
# with a ragged key mask), GQA with uneven unequal lengths, Lq > Lk, and
# head dim 128. float32 gradients within 1e-4 of max|ref| (float32 sums in
# another order); bf16 within 2e-2 of max|ref| and 1e-2 relative Frobenius,
# the forward's bf16 gate. Both directions start from the kernel's own
# forward output and LSE.

BWD_CASES = {  # b, lq, lk, h, kvh, d, causal, mask ("ones", "ragged", "dead_row", None)
    "fm_train": (8, 256, 256, 16, 16, 64, False, "ones"),
    "ar_train": (8, 516, 516, 20, 20, 64, True, "ragged"),
    "gqa_uneven": (2, 200, 333, 8, 2, 64, False, "ragged"),
    "gqa_causal_tails": (1, 37, 53, 8, 2, 64, True, "ragged"),
    "lq_gt_lk": (1, 50, 30, 2, 1, 64, False, None),
    "d128": (2, 190, 190, 4, 2, 128, True, "ragged"),
    "tile_edges": (2, 129, 193, 8, 8, 64, False, "ragged"),
    "tile_edges_causal": (1, 193, 129, 4, 2, 64, True, "ragged"),
    "short_keys": (2, 70, 20, 4, 2, 64, True, "ragged"),
    "gqa16_4_ragged": (2, 256, 256, 16, 4, 64, False, "ragged"),
    "d128_edges": (1, 129, 193, 4, 2, 128, False, "ragged"),
    "dead_row": (3, 150, 150, 8, 4, 64, False, "dead_row"),
}


def _bwd_inputs(cuda, case, dtype):
    b, lq, lk, h, kvh, d, causal, mask_kind = BWD_CASES[case]
    g = torch.Generator(cuda).manual_seed(lq * 7 + lk)
    q, do = (torch.randn((b, lq, h, d), generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, lk, kvh, d), generator=g, device=cuda).to(dtype) for _ in range(2))
    mask = None
    if mask_kind == "ones":
        mask = torch.ones((b, lk), device=cuda)
    elif mask_kind is not None:
        mask = _ragged_mask(cuda, b, lk, mask_kind)
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
@pytest.mark.parametrize("shape", SNAKE_SHAPES + [(2, 5001, 48), (1, 12345, 33)], ids=str)
def test_aa_snake_kernel_matches_plain(cuda, shape, dtype):
    """Kernel 2 against the plain version of the same fused arithmetic over
    the whole signal, edges included: float32 bit-equal, bf16 within one
    bf16 step of the float32 result rounded. The last two shapes end in a
    partial run of the kernel and take 48 and 33 channels."""
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
        assert torch.equal(out, ref), _rel_err(out, ref)
    else:
        _within_one_bf16_step(out, ref)


def test_aa_snake_kernel_exact_where_its_fast_path_is_not(cuda):
    """Kernel 2 bit-equal to its plain version where its fast sine and
    division would not give the plain version's bits and it recomputes:
    |alpha u| beyond the short argument reduction, subnormal sin^2, an
    extreme beta; and where they do: exact zeros."""
    from amphion_tpu_torch.ops.kernels.aa_snake import aa_snakebeta, aa_snakebeta_ref

    g = torch.Generator(cuda).manual_seed(11)
    x = torch.randn((2, 300, 40), generator=g, device=cuda) * 3
    x[0, 40:80] = 0.0
    x[0, 120:160] = 1e-30
    x[1, 200:240] *= 1e4
    alpha, beta = (torch.rand(40, generator=g, device=cuda) * 1.5 + 0.5 for _ in range(2))
    alpha[3], alpha[17] = 2e5, 1e-20
    beta[5], beta[9] = 1e10, 0.0
    out = aa_snakebeta(x, alpha, beta)
    ref = aa_snakebeta_ref(x, alpha, beta)
    assert torch.equal(out, ref), _rel_err(out, ref)


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


def _snake_inputs(cuda, shape, dtype, seed, scale=3.0):
    g = torch.Generator(cuda).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=cuda) * scale).to(dtype)
    a = torch.rand(shape[-1], generator=g, device=cuda) * 1.5 + 0.5
    gout = torch.randn(shape, generator=g, device=cuda).to(dtype)
    return x, a, gout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 320, 256), (2, 300, 37), (3, 1001, 6), (1, 7, 3)],
                         ids=str)
def test_snake_kernels_bit_equal_to_plain_and_on_relaunch(cuda, shape, dtype):
    """Kernel 1's y and dx equal the plain versions' float32 results to the
    bit (bf16: within one bf16 step), dx, y and dalpha bit-equal on
    relaunch, with C a multiple of 4 (16-byte accesses) and not (one
    channel a thread)."""
    from amphion_tpu_torch.ops.kernels.snake import snake, snake_bwd, snake_bwd_ref, snake_ref

    x, a, gout = _snake_inputs(cuda, shape, dtype, sum(shape) + 5)
    y, y2 = snake(x, a), snake(x, a)
    (dx, da), (dx2, da2) = snake_bwd(x, a, gout), snake_bwd(x, a, gout)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(dx, dx2) and torch.equal(da, da2)
    ref_dx, ref_da = snake_bwd_ref(x, a, gout)
    if dtype == torch.float32:
        assert torch.equal(y, snake_ref(x, a)), _rel_err(y, snake_ref(x, a))
        assert torch.equal(dx, ref_dx), _rel_err(dx, ref_dx)
    else:
        _within_one_bf16_step(y, snake_ref(x, a))
        _within_one_bf16_step(dx, ref_dx)
    assert _rel_err(da, ref_da) <= 1e-5


def test_snake_kernels_on_unaligned_tensors(cuda):
    """x, g and the outputs starting 4 bytes past a 16-byte boundary (a
    contiguous view at an offset): the kernels take one channel a thread."""
    from amphion_tpu_torch.ops.kernels.snake import snake, snake_bwd, snake_bwd_ref, snake_ref

    shape = (2, 500, 64)
    n = shape[0] * shape[1] * shape[2]
    x = (torch.randn(n + 1, device=cuda) * 3)[1:].view(shape)
    gout = torch.randn(n + 1, device=cuda)[1:].view(shape)
    a = torch.rand(64, device=cuda) + 0.5
    assert x.data_ptr() % 16 and gout.data_ptr() % 16
    assert torch.equal(snake(x, a), snake_ref(x, a))
    dx, da = snake_bwd(x, a, gout)
    ref_dx, ref_da = snake_bwd_ref(x, a, gout)
    assert torch.equal(dx, ref_dx) and _rel_err(da, ref_da) <= 1e-5


def test_snake_kernels_exact_where_their_fast_path_is_not(cuda):
    """Kernel 1 bit-equal to its plain version where its fast sine and
    division would not give the plain version's bits and it recomputes:
    |alpha x| and |2 alpha x| beyond the short argument reduction (105615),
    subnormal sin^2, an extreme alpha; and exact zeros."""
    from amphion_tpu_torch.ops.kernels.snake import snake, snake_bwd, snake_bwd_ref, snake_ref

    x, a, gout = _snake_inputs(cuda, (2, 300, 40), torch.float32, 13)
    x[0, 40:80] = 0.0
    x[0, 120:160] = 1e-30
    x[1, 200:240] *= 1e5
    x[1, 250:260] = 60000.0
    a[3], a[17], a[21] = 2e5, 1e-20, 1e12
    y = snake(x, a)
    dx, da = snake_bwd(x, a, gout)
    assert (a * x.abs().amax(dim=(0, 1)) >= 105615).any()
    assert torch.equal(y, snake_ref(x, a)), _rel_err(y, snake_ref(x, a))
    ref_dx, ref_da = snake_bwd_ref(x, a, gout)
    assert torch.equal(dx, ref_dx), _rel_err(dx, ref_dx)
    finite = ref_da.isfinite()
    assert torch.equal(finite, da.isfinite())
    assert _rel_err(da[finite], ref_da[finite]) <= 1e-5


def test_snake_bwd_dalpha_bit_equal_across_graph_replays(cuda):
    """Kernel 1's backward captured in a CUDA graph: its ticket counter is
    back at zero after each launch, so every replay's dalpha (and dx) equals
    the eager launch's to the bit."""
    from amphion_tpu_torch.ops.kernels.snake import SNAKE, snake_bwd

    x, a, gout = _snake_inputs(cuda, (16, 1280, 128), torch.float32, 17)
    dx0, da0 = snake_bwd(x, a, gout)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        snake_bwd(x, a, gout)  # the side stream's ticket, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n = SNAKE.tagged.get("bwd", 0)
    with torch.cuda.graph(graph, stream=side):
        dx, da = snake_bwd(x, a, gout)
    assert SNAKE.tagged["bwd"] == n + 1
    firsts = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        firsts.append((dx.clone(), da.clone()))
    for got_dx, got_da in firsts:
        assert torch.equal(got_da, da0) and torch.equal(got_dx, dx0)


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
