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


@pytest.mark.parametrize("b,t", [(1, 24000), (4, 120000), (2, 119 * 120), (1, 96000),
                                 (16, 3840), (16, 72000)])
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
    from amphion_tpu_torch.ops.kernels.mel import log_mel
    from amphion_tpu_torch.ops.mel import _fbank

    y = torch.randn((1, 24000), device=cuda, requires_grad=True)
    cfg = MelConfig()
    with pytest.raises(RuntimeError, match="no backward"):  # mel_spectrogram: LogMelFn
        log_mel(y, _fbank(cfg, y.device), cfg.n_fft, cfg.hop_size, cfg.win_size, cfg.clip_val)
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


# -- the row-invariant quantized decode: RMSNorm, the bf16 lm_head GEMV, the engine -----

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d", [(1, 1280), (4, 1280), (8, 1280), (2316, 1280), (3, 1000),
                                    (5, 33)])
def test_rms_norm_kernel_matches_plain(cuda, rows, d, dtype):
    """The kernel against the plain version (float32 within 1e-5 of
    max|ref|; bf16 within one bf16 step), relaunched bit for bit, and each
    of the first rows alone equal to its row in the full call."""
    from amphion_tpu_torch.ops.kernels.rms_norm import RMS_NORM, rms_norm, rms_norm_ref

    g = torch.Generator(cuda).manual_seed(rows + d)
    x = (torch.randn((rows, d), generator=g, device=cuda) * 3).to(dtype)
    w = (1 + 0.2 * torch.randn((d,), generator=g, device=cuda)).to(dtype)
    n = RMS_NORM.launches
    out = rms_norm(x, w, 1e-6)
    torch.cuda.synchronize()
    assert RMS_NORM.launches == n + 1 and out.dtype == dtype and out.shape == x.shape
    ref = rms_norm_ref(x, w, 1e-6)
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    else:
        _within_one_bf16_step(out, ref)
    assert torch.equal(rms_norm(x, w, 1e-6), out)
    for r in range(min(rows, 4)):
        assert torch.equal(rms_norm(x[r:r + 1], w, 1e-6)[0], out[r]), r


@pytest.mark.parametrize("m", [1, 3, 8, 9, 16])
@pytest.mark.parametrize("k,n", [(1280, 8244), (64, 100), (4096, 1280)])
def test_bf16_gemv_kernel_matches_plain(cuda, m, k, n):
    """The lm_head GEMV against the plain version (bf16 bounds), relaunched
    bit for bit, and row r alone equal to row r of the full call (M > 8
    runs in launches of 8 rows)."""
    from amphion_tpu_torch.ops.kernels.bf16_gemv import BF16_GEMV, bf16_linear, bf16_linear_ref

    g = torch.Generator(cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda).bfloat16()
    w = (torch.randn((n, k), generator=g, device=cuda) * k ** -0.5).bfloat16()
    launches = BF16_GEMV.launches
    out = bf16_linear(x, w)
    torch.cuda.synchronize()
    assert BF16_GEMV.launches == launches + 1 and out.shape == (m, n)
    _close(out, bf16_linear_ref(x, w), torch.bfloat16)
    assert torch.equal(bf16_linear(x, w), out)
    for r in range(m):
        assert torch.equal(bf16_linear(x[r:r + 1], w)[0], out[r]), r


def test_row_invariant_wrappers_raise_on_what_they_do_not_take(cuda):
    from amphion_tpu_torch.ops.kernels.bf16_gemv import bf16_linear
    from amphion_tpu_torch.ops.kernels.rms_norm import rms_norm

    x = torch.randn((2, 48), device=cuda).bfloat16()
    with pytest.raises(ValueError, match="K % 32"):
        bf16_linear(x, torch.randn((8, 48), device=cuda).bfloat16())
    with pytest.raises(ValueError, match="bf16"):
        bf16_linear(x.float(), torch.randn((8, 48), device=cuda))
    with pytest.raises(ValueError, match="gain"):
        rms_norm(x, torch.ones(48, device=cuda), 1e-6)
    with pytest.raises(RuntimeError, match="no backward"):
        rms_norm(torch.randn((2, 48), device=cuda, requires_grad=True),
                 torch.ones(48, device=cuda), 1e-6)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_continuous_engine_graphs_match_eager_and_solo(cuda, dtype):
    """A small quantized AR on the card: the engine replaying CUDA graphs
    gives each of four staggered requests the tokens of the eager engine and
    of its one-shot ragged decode at the engine's capacity; the replays
    count their launches (one GEMV per projection, one RMSNorm per norm, one
    lm_head GEMV per step and row set)."""
    from amphion_tpu_torch.models.vc.ar_transformer import (
        ARTransformer, ARTransformerConfig, ar_transformer_generate_ragged, prepare_for_decode)
    from amphion_tpu_torch.ops.kernels.bf16_gemv import BF16_GEMV
    from amphion_tpu_torch.ops.kernels.rms_norm import RMS_NORM
    from amphion_tpu_torch.serving.continuous import ContinuousARBatcher

    torch.manual_seed(0)
    with torch.device(cuda):
        model = prepare_for_decode(ARTransformer(ARTransformerConfig(
            input_vocab=16, output_vocab=256, hidden=128, intermediate=256, num_layers=2,
            num_heads=2, max_position=512)).eval(), dtype)
    rng = torch.Generator().manual_seed(1)
    reqs = [(torch.randint(0, 16, (int(5 + 7 * i),), generator=rng), 70 + i,
             torch.randint(0, 256, (int(20 + 9 * i),), generator=rng)) for i in range(4)]
    kw = dict(slots=4, chunk=8, buckets=(32, 64), out_buckets=(32, 64), max_new=40,
              temperature=1.0, top_k=20, compute_dtype=dtype)
    out = {}
    for graphs in (True, False):
        eng = ContinuousARBatcher(model, graphs=graphs, **kw)
        rids = []
        for content, seed, po in reqs:
            rids.append(eng.submit(content, seed, prompt_output=po))
            eng.step_chunk()
        n8, nrms = BF16_GEMV.launches, RMS_NORM.launches
        done = eng.run()
        out[graphs] = [done[r] for r in rids]
        if graphs:
            assert eng.step_launches(1) == {"rms_norm": 5, "bf16_gemv": 1,
                                            f"{dtype}_matmul": 8}
            # the replays after the fourth admission: at least a chunk of steps
            assert BF16_GEMV.launches - n8 >= eng.chunk
            assert RMS_NORM.launches - nrms >= 5 * eng.chunk
    for i, (content, seed, po) in enumerate(reqs):
        toks, n = ar_transformer_generate_ragged(
            model, torch.nn.functional.pad(content, (0, 32 - len(content)))[None].to(cuda),
            torch.tensor([len(content)], device=cuda), [torch.Generator(cuda).manual_seed(seed)],
            max_new=40, top_k=20, compute_dtype=dtype, capacity=eng.capacity,
            prompt_output_tokens=torch.nn.functional.pad(po, (0, eng._bucket(
                len(po), eng.out_buckets) - len(po)))[None].to(cuda),
            prompt_output_len=torch.tensor([len(po)], device=cuda))
        solo = toks[0, :int(n[0])].cpu()
        assert torch.equal(out[True][i], out[False][i]), i
        assert torch.equal(out[True][i], solo), i



# -- VALL-E's shapes (config/valle.json: width 1024, FFN 2816, a 1025-wide head) --
# #4/#5 at the AR's projections, qkv (1024 → 3072), o (1024 → 1024), gateup
# (1024 → 5632) and down (2816 → 1024): the decode's GEMV at 1, 4 and 8 rows
# (K = 2816 splits into 44 int8 chunks and 22 int4 groups over the cluster)
# and the GEMM at an admission's prefill (128 phones + 512 prompt frames).
VALLE_PROJ = [(1024, 3072), (1024, 1024), (1024, 5632), (2816, 1024)]


@pytest.mark.parametrize("k,n", VALLE_PROJ, ids=str)
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quant_matmuls_at_valle_shapes(cuda, kind, k, n):
    """Kernel 4 or 5 against its plain version at VALL-E's projections: the
    GEMV at M = 1, 4 and 8 (float32 within 1e-4 of max|ref|, bf16 within a
    rounding), relaunched bit for bit, each row alone equal to its row among
    8; the GEMM at 640 rows, relaunched bit for bit."""
    x8, run = _quant_weights(cuda, kind, k, n, k + n + (kind == "int4"))
    ref = _quant_ref(cuda, kind, k, n, k + n + (kind == "int4"))
    for m in (1, 4, 8):
        x = x8[:m]
        for dt in (torch.float32, torch.bfloat16):
            out = run(x, dt)
            _mm_close(out, ref(x, dt))
            assert torch.equal(run(x, dt), out)
            full = run(x8, dt)
            assert all(torch.equal(full[r], out[r]) for r in range(m)), (m, dt)
    g = torch.Generator(cuda).manual_seed(k * n)
    xg = torch.randn((640, k), generator=g, device=cuda).bfloat16()
    out = run(xg, torch.float32)
    _mm_close(out, ref(xg, torch.float32))
    assert torch.equal(run(xg, torch.float32), out)


def _quant_ref(cuda, kind, k, n, seed):
    """The plain version of `_quant_weights`'s projection, same weights."""
    from amphion_tpu_torch.ops.kernels.int4_matmul import (
        int4_matmul_ref, pack_int4, quantize_weight_int4)
    from amphion_tpu_torch.ops.kernels.int8_matmul import int8_matmul_ref, quantize_weight_int8

    g = torch.Generator(cuda).manual_seed(seed)
    w = (torch.randn((n, k), generator=g, device=cuda) * 0.05).bfloat16()
    if kind == "int8":
        w_q, scale = quantize_weight_int8(w)
        return lambda xx, dt: int8_matmul_ref(xx, w_q, scale, dt)
    w_int, scale = quantize_weight_int4(w, 128)
    w_p = pack_int4(w_int)
    return lambda xx, dt: int4_matmul_ref(xx, w_p, scale, 128, None, 1e-6, dt)


@pytest.mark.parametrize("m", [1, 4, 8])
def test_bf16_gemv_at_valle_head(cuda, m):
    """The head GEMV at VALL-E's 1025 × 1024 head (N odd: a 1-column last
    tile) against the plain version, relaunched bit for bit, each row alone
    equal to its row in the call."""
    from amphion_tpu_torch.ops.kernels.bf16_gemv import bf16_linear, bf16_linear_ref

    g = torch.Generator(cuda).manual_seed(1025 + m)
    x = torch.randn((m, 1024), generator=g, device=cuda).bfloat16()
    w = (torch.randn((1025, 1024), generator=g, device=cuda) / 32).bfloat16()
    out = bf16_linear(x, w)
    assert out.shape == (m, 1025)
    _close(out, bf16_linear_ref(x, w), torch.bfloat16)
    assert torch.equal(bf16_linear(x, w), out)
    for r in range(m):
        assert torch.equal(bf16_linear(x[r:r + 1], w)[0], out[r]), r


def test_valle_engine_graphs_match_eager_and_solo(cuda):
    """A small int8 VALL-E on the card: the engine replaying a CUDA graph a
    rung gives each of four staggered requests the codebook-0 tokens of the
    eager engine and of its one-shot ragged decode at the engine's capacity;
    a captured step holds 25 launches a pass... here 2 layers: 5 RMSNorms, 8
    GEMVs and the head."""
    from amphion_tpu_torch.models.tts.valle.valle import (
        VALLE, VALLEConfig, ar_generate_ragged, prepare_for_decode)
    from amphion_tpu_torch.serving.continuous import ContinuousValleBatcher
    from amphion_tpu_torch.utils.convert import init_like_flax

    with torch.device(cuda):
        model = init_like_flax(VALLE(VALLEConfig(
            num_phones=64, audio_vocab=64, num_quantizers=3, hidden=128, num_layers=2,
            num_heads=2, max_position=512)), torch.Generator(cuda).manual_seed(0))
    model = prepare_for_decode(model.eval(), "int8")
    rng = torch.Generator().manual_seed(1)
    reqs = [(torch.randint(1, 64, (int(9 + 7 * i),), generator=rng),
             torch.randint(0, 64, (int(12 + 9 * i),), generator=rng), 70 + i) for i in range(4)]
    kw = dict(slots=4, chunk=8, phone_buckets=(16, 48), prompt_buckets=(32, 64), max_new=40,
              temperature=1.0, top_k=20, compute_dtype="int8")
    out = {}
    for graphs in (True, False):
        eng = ContinuousValleBatcher(model, graphs=graphs, **kw)
        rids = []
        for ph, pr, seed in reqs:
            rids.append(eng.submit(ph, pr, seed))
            eng.step_chunk()
        done = eng.run()
        out[graphs] = [done[r] for r in rids]
        if graphs:
            assert eng.capacity == 48 + 64 + 40 + 8
            for r in eng.rungs:
                assert eng.step_launches(r) == {"rms_norm": 5, "bf16_gemv": 1, "int8_matmul": 8}
    for i, (ph, pr, seed) in enumerate(reqs):
        pad = torch.nn.functional.pad
        toks, n = ar_generate_ragged(
            model, pad(ph, (0, eng._bucket(len(ph)) - len(ph)))[None],
            torch.tensor([len(ph)]),
            pad(pr, (0, eng._bucket(len(pr), eng.out_buckets) - len(pr)))[None],
            torch.tensor([len(pr)]), [torch.Generator(cuda).manual_seed(seed)], max_new=40,
            top_k=20, compute_dtype="int8", capacity=eng.capacity)
        assert torch.equal(out[True][i], out[False][i]), i
        assert torch.equal(out[True][i], toks[0, :int(n[0])].cpu()), i

def _tiny_codec():
    from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec, CodecConfig
    from amphion_tpu_torch.utils.convert import init_like_flax

    codec = AmphionCodec(CodecConfig(encoder_dim=8, latent_dim=16, decoder_dim=8,
                                     strides=(2, 5), num_quantizers=3, codebook_size=32,
                                     codebook_dim=4))
    init_like_flax(codec, torch.Generator().manual_seed(4))
    with torch.no_grad():  # Snake α away from 1, so that each channel's own α counts
        for name, p in codec.named_parameters():
            if name.endswith("alpha"):
                p.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(len(name)))
    return codec.eval()


def test_codec_snake_runs_kernel_1_and_matches_cpu(cuda):
    """The Amphion codec's Snake layers launch kernel 1 on the card (one per
    activation: 2 strides x 7 + 1 = 15 a pass) and the codec matches its
    CPU run (plain Snake): codes equal, the length-masked decode within
    1e-4."""
    from amphion_tpu_torch.ops.kernels.snake import SNAKE

    cpu = _tiny_codec()
    card = _tiny_codec().to(cuda)
    audio = torch.randn((2, 400), generator=torch.Generator().manual_seed(5)) * 0.3
    n = SNAKE.launches
    codes = card.encode(audio.to(cuda))
    torch.cuda.synchronize()
    assert SNAKE.launches == n + 2 * 7 + 1  # per stride 3 units x 2 + 1, and a final one
    assert torch.equal(codes.cpu(), cpu.encode(audio))
    lens = torch.tensor([40, 23])
    n = SNAKE.launches
    wav = card.decode_codes(codes, lens.to(cuda))
    torch.cuda.synchronize()
    assert SNAKE.launches == n + 15
    ref = cpu.decode_codes(codes.cpu(), lens)
    assert wav.shape == ref.shape == (2, 400)
    assert (wav.cpu() - ref).abs().max().item() <= 1e-4


def test_maskgct_batch_card_matches_cpu(cuda):
    """A small MaskGCT batch (T2S, S2A on float conditioning, the codec
    decode) on the card in float32 against the CPU, with the same injected
    draws: tokens equal, waveforms within 1e-4; every backbone pass runs
    kernel 6 (one launch per layer and pass)."""
    import numpy as np

    from amphion_tpu_torch.models.tts.maskgct import ragged_sampling as rs
    from amphion_tpu_torch.models.tts.maskgct.maskgct import (
        MaskGCTS2A, MaskGCTT2S, S2AConfig, T2SConfig)
    from amphion_tpu_torch.utils.convert import init_like_flax

    g = torch.Generator().manual_seed(6)
    t2s = init_like_flax(MaskGCTT2S(T2SConfig(hidden=128, num_layers=2, num_heads=2,
                                              codebook_size=64, phone_vocab=40)), g).eval()
    s2a = init_like_flax(MaskGCTS2A(S2AConfig(hidden=128, num_layers=2, num_heads=2,
                                              codebook_size=32, num_quantizers=3,
                                              semantic_dim=24), False, True), g).eval()
    codec = _tiny_codec()
    rng = np.random.default_rng(7)
    b, lp, lph, tm = 3, 12, 16, 24
    inputs = dict(prompt=rng.integers(0, 64, (b, lp)), plen=[12, 7, 10],
                  phone=rng.integers(1, 40, (b, lph)), phlen=[16, 9, 13],
                  tlen=[24, 17, 20], pac=rng.integers(0, 32, (b, 3, lp)),
                  sem=rng.standard_normal((b, lp + tm, 24)).astype(np.float32))
    t2s_draws = [rng.gumbel(size=(b, tm, 64) if i % 2 == 0 else (b, tm)).astype(np.float32)
                 for i in range(2 * 4)]
    s2a_draws = [rng.gumbel(size=(b, tm, 32) if i % 2 == 0 else (b, tm)).astype(np.float32)
                 for i in range(2 * (3 + 2))]
    out = {}
    for dev in ("cpu", cuda):
        t2s.to(dev), s2a.to(dev), codec.to(dev)

        def L(k):
            return torch.as_tensor(np.asarray(inputs[k])).long().to(dev)
        n6 = FLASH.launches
        sem = rs.t2s_sample_ragged(t2s, L("prompt"), L("plen"), L("phone"), L("phlen"),
                                   L("tlen"), [None] * b, tm, n_steps=4, compute_dtype="float32",
                                   gumbel=iter(t2s_draws))
        codes = rs.s2a_sample_ragged(s2a, torch.as_tensor(inputs["sem"]).to(dev), L("pac"),
                                     L("plen"), L("tlen"), [None] * b, tm, first_layer_steps=3,
                                     compute_dtype="float32", gumbel=iter(s2a_draws))
        wav = codec.decode_codes(codes.transpose(0, 1), L("tlen"))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert FLASH.launches - n6 == 2 * 2 * (4 + 3 + 2)
        out[str(dev)] = (sem.cpu(), codes.cpu(), wav.cpu())
    for a, c in zip(out["cpu"][:2], out["cuda"][:2]):
        assert torch.equal(a, c)
    assert (out["cpu"][2] - out["cuda"][2]).abs().max().item() <= 1e-4


def test_mel_kernel_under_inference_mode(cuda):
    """The MaskGCT front end runs the mel under ``torch.inference_mode``: a
    filterbank first asked for there, and an inference-mode filterbank
    handed to the wrapper, both work."""
    from amphion_tpu_torch.ops.kernels.mel import log_mel, log_mel_ref
    from amphion_tpu_torch.ops.mel import _fbank

    cfg = MelConfig(fmax=11025.0)  # a filterbank no other test has cached
    y = torch.randn((1, 24000), generator=torch.Generator(cuda).manual_seed(3),
                    device=cuda) * 0.3
    with torch.inference_mode():
        out = mel_spectrogram(y, cfg)
        fb = _fbank(cfg, y.device).clone()
        assert fb.is_inference()
        again = log_mel(y, fb, cfg.n_fft, cfg.hop_size, cfg.win_size, cfg.clip_val)
    ref = mel_spectrogram_ref(y, cfg)
    assert (out - ref).abs().max().item() <= 1e-3 and torch.equal(again, out)
    assert (log_mel_ref(y, fb, cfg.n_fft, cfg.hop_size, cfg.win_size, cfg.clip_val)
            - ref).abs().max().item() == 0.0



# -- GAN vocoder training: LogMelFn (kernel 3 under grad) and a small step ---------


@pytest.mark.parametrize("b,t", [(16, 7680), (2, 24000 + 37), (16, 3840)])
def test_log_mel_fn_forward_is_kernel_3_and_grad_is_plain_autograd(cuda, b, t):
    """`mel_spectrogram` under grad runs kernel 3 once through `LogMelFn`:
    the forward within 1e-3 of `log_mel_ref`, the signal's gradient equal
    to the bit to autograd of `log_mel_ref` on the same inputs (the GAN
    trainer's batch, 16 x 7680, a ragged length, and VITS's generated
    segments, 16 x 3840)."""
    from amphion_tpu_torch.ops.kernels.mel import log_mel_ref
    from amphion_tpu_torch.ops.mel import _fbank

    cfg = MelConfig()
    gen = torch.Generator(cuda).manual_seed(t)
    y = (torch.randn((b, t), generator=gen, device=cuda) * 0.3).requires_grad_()
    g = torch.randn((b, 80, t // 120), generator=gen, device=cuda)
    n = MEL.launches
    out = mel_spectrogram(y, cfg)
    torch.cuda.synchronize()
    assert MEL.launches == n + 1 and type(out.grad_fn).__name__ == "LogMelFnBackward"
    (dy,) = torch.autograd.grad(out, y, g)
    assert MEL.launches == n + 1  # the backward launches no kernel
    y2 = y.detach().requires_grad_()
    ref = log_mel_ref(y2, _fbank(cfg, y.device), cfg.n_fft, cfg.hop_size, cfg.win_size,
                      cfg.clip_val)
    (dref,) = torch.autograd.grad(ref, y2, g)
    assert (out - ref).abs().max().item() <= 1e-3
    assert torch.equal(dy, dref)


GAN_SMALL = {  # a small float32 GAN that the mel kernel takes (n_fft 256)
    "mel": dict(sample_rate=16000, n_fft=256, win_size=128, hop_size=16, n_mel=32, fmax=8000),
    "gen": dict(n_mel=32, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                resblock_dilation_sizes=((1, 3),), use_pallas_act=True),
    "disc": dict(use=("mpd", "msd", "mrd"), mpd_periods=(2, 3), msd_scales=2,
                 channel_mult=0.25, mrd_resolutions=((256, 32, 128),)),
}


def test_gan_step_card_matches_cpu(cuda):
    """One D-then-G step of a small float32 GAN (MPD, MSD and MRD; kernels 2
    and 3 on the card, their plain versions on the CPU) from the same
    weights and batch: every loss within 1e-4 relative, and every updated
    parameter's update within 1 % of the learning rate of the CPU's for all
    but 1e-3 of the elements (Adam's first update is about the gradient's
    sign: an element whose gradient is near 0 may flip)."""
    import copy

    from amphion_tpu_torch.models.vocoders.bigvgan import BigVGANConfig, BigVGANGenerator
    from amphion_tpu_torch.models.vocoders.gan_trainer import (
        CombinedDiscriminator, GANTrainConfig, create_gan_states, make_gan_train_step)
    from amphion_tpu_torch.ops.kernels.aa_snake import AA_SNAKE
    from amphion_tpu_torch.utils.convert import init_like_flax

    mel_cfg = MelConfig(**GAN_SMALL["mel"])
    gen = torch.Generator().manual_seed(5)
    g = init_like_flax(BigVGANGenerator(BigVGANConfig(**GAN_SMALL["gen"])), gen)
    d = init_like_flax(CombinedDiscriminator(**GAN_SMALL["disc"]), gen)
    with torch.no_grad():
        for p in list(g.parameters()) + list(d.parameters()):
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    audio = torch.sin(torch.arange(2 * 32 * 16).reshape(2, -1) * torch.tensor([[0.05], [0.11]]))
    audio = 0.4 * audio + 0.02 * torch.randn(audio.shape, generator=gen)
    mel = mel_spectrogram_ref(audio, mel_cfg).transpose(1, 2).contiguous()
    res = {}
    for dev in ("cpu", "cuda"):
        gd, dd = copy.deepcopy(g).to(dev), copy.deepcopy(d).to(dev)
        gs, ds = create_gan_states(gd, dd, GANTrainConfig())
        n2, n3 = AA_SNAKE.launches, MEL.launches
        _, _, m = make_gan_train_step(mel_cfg)(gs, ds, {"audio": audio.to(dev),
                                                        "mel": mel.to(dev)})
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (AA_SNAKE.launches - n2, MEL.launches - n3) == (2 * 9, 2)
        res[dev] = ({k: v.item() for k, v in m.items()},
                    [p.detach().cpu() for p in list(gd.parameters()) + list(dd.parameters())])
    for k, v in res["cpu"][0].items():
        assert abs(res["cuda"][0][k] - v) <= 1e-4 * abs(v), k
    start = list(g.parameters()) + list(d.parameters())
    lr = GANTrainConfig().lr
    off = total = 0
    for s, a, c in zip(start, res["cuda"][1], res["cpu"][1]):
        diff = ((a - s.detach()) - (c - s.detach())).abs()
        off += int((diff > 1e-2 * lr).sum())
        total += diff.numel()
        assert diff.max().item() <= 2.1 * lr
    assert off <= 1e-3 * total, (off, total)


def _hifigan_checkpoint(tmp_path):
    """A HiFi-GAN at the egs width (`egs/vocoder/gan/hifigan`) drawn by
    `init_like_flax`, its last conv's scale cut to 0.1 so that the tanh is
    not saturated, saved as a vocoder checkpoint; a 1 s synthetic file."""
    import numpy as np

    from amphion_tpu_torch.data.audio_io import save_wav
    from amphion_tpu_torch.models.vocoders.hifigan import HiFiGANConfig, HiFiGANGenerator
    from amphion_tpu_torch.runtime.vocoder_trainer import save_generator
    from amphion_tpu_torch.utils.convert import init_like_flax

    gen = init_like_flax(HiFiGANGenerator(HiFiGANConfig()), torch.Generator().manual_seed(3))
    with torch.no_grad():
        gen.Conv_1.scale.mul_(0.1)
    save_generator(tmp_path / "ckpt", gen)
    t = np.arange(24000) / 24000.0
    x = 0.3 * np.sin(2 * np.pi * 180 * t * (1 + 0.2 * t)) + 0.01 * np.sin(2 * np.pi * 3100 * t)
    save_wav(tmp_path / "wav" / "a.wav", x.astype(np.float32), 24000)
    return gen


def test_vocoder_cli_computes_float32_convolutions_in_float32(cuda, tmp_path, monkeypatch):
    """`bins/vocoder/inference.py` turns TF32 off itself: with PyTorch's
    default (cuDNN's TF32 on) set before the call, the CLI's HiFi-GAN output
    (taken before the PCM16 wav) is within 1e-4 of its max|ref| of a float64
    forward of the same weights on the same mel. The same forward with TF32
    on lands near 1e-3 of max|ref|, which this tolerance catches."""
    import numpy as np

    from amphion_tpu_torch.bins.vocoder import inference
    from amphion_tpu_torch.data.audio_io import load_wav

    gen = _hifigan_checkpoint(tmp_path)
    written = []
    save = inference.save_wav
    monkeypatch.setattr(inference, "save_wav",
                        lambda path, x, sr: (written.append(np.asarray(x)), save(path, x, sr)))
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default; the fixture restores it
    inference.main(["--config", "egs/vocoder/gan/hifigan/exp_config.json", "--checkpoint_path",
                    str(tmp_path / "ckpt"), "--output_dir", str(tmp_path / "out"), "--mode",
                    "from_audio", "--audio_dir", str(tmp_path / "wav")])
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    x, _ = load_wav(tmp_path / "wav" / "a.wav", sr=24000)
    mel = mel_spectrogram(torch.from_numpy(x).to(cuda)[None], MelConfig()).transpose(1, 2)
    with torch.no_grad():
        ref = gen.double().to(cuda)(mel.double())[0].cpu().numpy()
        gen.float()
        torch.backends.cudnn.allow_tf32 = True
        tf32 = gen(mel)[0].cpu().numpy()
    assert len(written) == 1 and written[0].shape == ref.shape
    assert np.mean(np.abs(ref) > 0.99) < 0.05  # not saturated by the tanh
    scale = np.abs(ref).max()
    err, err_tf32 = np.abs(written[0] - ref).max() / scale, np.abs(tf32 - ref).max() / scale
    print(f"max|ref| {scale:.4g}; relative error float32 {err:.3g}, TF32 {err_tf32:.3g}")
    assert err <= 1e-4, (err, err_tf32)
    assert err_tf32 > 1e-4, (err, err_tf32)


def test_yin_and_cqt_card_match_cpu(cuda):
    """`ops/f0.yin_f0` at the base front end (24 kHz, hop 120) and
    `ops/cqt.cqt` at MS-SB-CQT's first scale (48 kHz, hop 512, 9 octaves of
    24 bins) on the card against the CPU: F0 within 1e-3 relative or both
    unvoiced on at least 99 % of the frames (a frame near the voicing
    threshold may flip), the CQT within 1e-5 of its max|ref|."""
    import numpy as np

    from amphion_tpu_torch.ops.cqt import cqt
    from amphion_tpu_torch.ops.f0 import F0Config, yin_f0

    rng = np.random.default_rng(0)
    t = np.arange(48000) / 24000.0
    rows = [np.sin(2 * np.pi * f * t * (1 + 0.1 * np.sin(3 * t))) for f in (110, 220, 347)]
    rows.append(rng.standard_normal(t.shape) * 0.1)
    y = torch.from_numpy((0.4 * np.stack(rows)).astype(np.float32))
    f_cpu, v_cpu = yin_f0(y, F0Config())
    f_gpu, v_gpu = (a.cpu() for a in yin_f0(y.to(cuda), F0Config()))
    agree = (v_gpu == v_cpu) & (~v_cpu | ((f_gpu - f_cpu).abs() <= 1e-3 * f_cpu.abs()))
    assert agree.float().mean().item() >= 0.99
    assert v_cpu[:3].float().mean().item() > 0.9
    kw = dict(sr=48000, hop_length=512, n_bins=216, bins_per_octave=24)
    c_cpu = cqt(y, **kw)
    c_gpu = cqt(y.to(cuda), **kw).cpu()
    assert c_gpu.shape == c_cpu.shape
    assert (c_gpu - c_cpu).abs().max().item() <= 1e-5 * c_cpu.abs().max().item()


def test_hifigan_gan_step_launches_mel_kernel_three_times(cuda):
    """A HiFi-GAN GAN step as the trainer runs it, on the card: kernel 3 once
    for the batch's mel and twice in the mel loss (the fake's through
    `LogMelFn`), no other kernel; every loss finite."""
    from amphion_tpu_torch.models.vocoders.gan_trainer import (
        CombinedDiscriminator, GANTrainConfig, create_gan_states, make_gan_train_step)
    from amphion_tpu_torch.models.vocoders.hifigan import HiFiGANConfig, HiFiGANGenerator
    from amphion_tpu_torch.ops.kernels.aa_snake import AA_SNAKE
    from amphion_tpu_torch.ops.kernels.snake import SNAKE
    from amphion_tpu_torch.utils.convert import init_like_flax

    mel_cfg = MelConfig(**GAN_SMALL["mel"])
    gen = torch.Generator(cuda).manual_seed(1)
    g = init_like_flax(HiFiGANGenerator(HiFiGANConfig(
        upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=64,
        n_mel=32)).to(cuda), gen)
    d = init_like_flax(CombinedDiscriminator(("mpd", "msd"), (2, 3), 1, 0.25).to(cuda), gen)
    gs, ds = create_gan_states(g, d, GANTrainConfig())
    audio = 0.3 * torch.sin(torch.arange(4 * 2048, device=cuda).reshape(4, -1) * 0.07)
    counts = [k.launches for k in (MEL, AA_SNAKE, SNAKE)]
    mel = mel_spectrogram(audio, mel_cfg).transpose(1, 2)
    _, _, m = make_gan_train_step(mel_cfg)(gs, ds, {"audio": audio, "mel": mel})
    torch.cuda.synchronize()
    assert [k.launches - c for k, c in zip((MEL, AA_SNAKE, SNAKE), counts)] == [3, 0, 0]
    assert all(torch.isfinite(v).item() for v in m.values())


# -- codec-LM training (VALL-E, MaskGCT) ----------------------------------------------


def _valle_train_inputs(device, b=4, lp=40, t=300, q=8, seed=9):
    """A VALL-E training batch: padded phones leave holes between a row's
    real phones and its codes in ``[phones; codes]``; ragged codes."""
    g = torch.Generator().manual_seed(seed)
    ph_len = torch.tensor([lp - 11 * i for i in range(b)])
    tok_len = torch.tensor([t - 37 * i for i in range(b)])
    pm = (torch.arange(lp)[None] < ph_len[:, None]).float()
    tm = (torch.arange(t)[None] < tok_len[:, None]).float()
    phones = torch.randint(1, 64, (b, lp), generator=g) * pm.long()
    codes = torch.randint(0, 1024, (b, q, t), generator=g)
    return [x.to(device) for x in (phones, pm, codes, tm)]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_bwd_at_valle_training_shape(cuda, causal):
    """Kernels 6 and 7 in float32 at a VALL-E training shape, (4, 340, 16,
    64) over ``[phones; codes]`` with the AR's key mask (causal) or the
    NAR's: padded phones sit between real phones and codes, so rows hold
    masked keys before real ones. Forward within 1e-4 of the plain version,
    dq/dk/dv within 1e-4 of max|ref|, each relaunched bit for bit."""
    from amphion_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref)

    _, pm, _, tm = _valle_train_inputs(cuda)
    mask = torch.cat([pm, tm], dim=1)
    real = mask > 0
    assert ((~real[:, :-1]) & real[:, 1:]).any(dim=1).sum() == 3  # the holes
    b, L, h, d = mask.shape[0], mask.shape[1], 16, 64
    g = torch.Generator(cuda).manual_seed(3)
    q, k, v, do = (torch.randn((b, L, h, d), generator=g, device=cuda) for _ in range(4))
    out, lse = flash_attention(q, k, v, mask, causal, return_lse=True)
    ref, ref_lse = attention_ref(q, k, v, mask, causal, return_lse=True)
    assert (out - ref).abs().max().item() <= 1e-4
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    grads = flash_attention_bwd(q, k, v, mask, out, lse, do, causal)
    again = flash_attention_bwd(q, k, v, mask, out, lse, do, causal)
    for got, r in zip(grads, flash_attention_bwd_ref(q, k, v, mask, out, lse, do, causal)):
        assert (got - r).abs().max().item() <= 1e-4 * r.abs().max().item()
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    assert torch.equal(out, flash_attention(q, k, v, mask, causal))


def test_valle_train_step_card_matches_cpu(cuda):
    """One VALL-E training step's loss and gradients at full width (1024,
    16 heads, 8 x 1024 codes) and 2 layers, float32, on the card against
    the CPU with the same weights, batch and draws: the losses within 1e-4
    relative, every gradient within 1e-3 of its tensor's max|ref|; kernels
    6 and 7 once a layer of each stage."""
    import copy

    from amphion_tpu_torch.models.tts.valle.valle import VALLE, VALLEConfig
    from amphion_tpu_torch.ops.kernels.flash_attention import FLASH_BWD
    from amphion_tpu_torch.utils.convert import init_like_flax

    g = torch.Generator().manual_seed(4)
    cpu = init_like_flax(VALLE(VALLEConfig(num_phones=64, num_layers=2)), g)
    with torch.no_grad():  # the adaptive norms off their identity start
        for name, p in cpu.named_parameters():
            if "to_weight.weight" in name:
                p.normal_(0.0, 0.02, generator=g)
    gpu = copy.deepcopy(cpu).to(cuda)
    res = {}
    for model in (cpu, gpu):
        dev = next(model.parameters()).device
        counts = FLASH.launches, FLASH_BWD.launches
        loss, aux = model.train_loss(*_valle_train_inputs(dev),
                                     stage=torch.tensor([1, 3, 5, 7], device=dev), plen=40)
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (FLASH.launches - counts[0], FLASH_BWD.launches - counts[1]) == (4, 4)
        res[dev.type] = ({k: v.item() for k, v in aux.items()},
                         {n: p.grad.cpu() for n, p in model.named_parameters()
                          if p.grad is not None})
    for k, ref in res["cpu"][0].items():
        assert abs(res["cuda"][0][k] - ref) <= 1e-4 * abs(ref), k
    assert res["cuda"][1].keys() == res["cpu"][1].keys()
    for name, ref in res["cpu"][1].items():
        err = (res["cuda"][1][name] - ref).abs().max().item()
        assert err <= 1e-3 * ref.abs().max().item(), name


# -- VITS and FastSpeech2: the alignment search on the card and a small VITS step ---------


@pytest.mark.parametrize("seed", [0, 1])
def test_maximum_path_on_the_card_equals_the_cpu(cuda, seed):
    """`ops/mas.maximum_path` on the card equals the CPU's to the bit: a
    random lattice at a VITS batch's shape with ragged text and mel lengths,
    and one of small integers (ties everywhere)."""
    from amphion_tpu_torch.ops.mas import maximum_path

    g = torch.Generator().manual_seed(seed)
    b, tt, tm = 16, 120, 600
    value = torch.randn((b, tt, tm), generator=g) * 10.0
    if seed:
        value = torch.randint(-2, 3, (b, tt, tm), generator=g).float()
    text = torch.randint(20, tt + 1, (b,), generator=g)
    mel = torch.randint(300, tm + 1, (b,), generator=g)
    mask = ((torch.arange(tt)[None, :, None] < text[:, None, None])
            & (torch.arange(tm)[None, None, :] < mel[:, None, None])).float()
    ref = maximum_path(value, mask)
    out = maximum_path(value.to(cuda), mask.to(cuda))
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(ref.sum(1), mask[:, 0, :])


def test_small_vits_step_card_vs_cpu(cuda):
    """One small float32 `make_vits_train_step` (kernel 3 twice: the real
    segments, then the generated ones through `LogMelFn`) on the card and on
    the CPU from the same weights, batch and draws: every loss within 1e-3
    relative, the alignment equal."""
    import copy

    from amphion_tpu_torch.models.tts.vits.vits import VITS, VITSConfig
    from amphion_tpu_torch.models.tts.vits.vits_trainer import (
        create_vits_states, make_vits_train_step, vits_draws)
    from amphion_tpu_torch.models.vocoders.gan_trainer import (
        CombinedDiscriminator, GANTrainConfig)
    from amphion_tpu_torch.models.vocoders.hifigan import HiFiGANConfig
    from amphion_tpu_torch.ops.mel import linear_spectrogram
    from amphion_tpu_torch.utils.convert import init_like_flax

    g = torch.Generator().manual_seed(5)
    dec = HiFiGANConfig(upsample_rates=(5, 4, 3, 2), upsample_initial_channel=32,
                        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),), n_mel=32)
    vits = init_like_flax(VITS(VITSConfig(num_phones=40, inter_channels=32, hidden_channels=32,
                                          filter_channels=64, n_layers=2, segment_size=16,
                                          decoder=dec)), g)
    disc = init_like_flax(CombinedDiscriminator(channel_mult=0.125), g)
    b, frames = 2, 80
    audio = torch.randn((b, frames * 120), generator=g) * 0.3
    pm = (torch.arange(30)[None] < torch.tensor([30, 21])[:, None]).float()
    batch = {"phones": torch.randint(1, 40, (b, 30), generator=g) * pm.long(),
             "phone_mask": pm, "spec": linear_spectrogram(audio, MelConfig()).transpose(1, 2),
             "spec_mask": (torch.arange(frames)[None] < torch.tensor([80, 61])[:, None]).float(),
             "audio": audio, "sid": torch.zeros(b, dtype=torch.long)}
    draws = vits_draws(vits, batch, g)
    res = {}
    for dev in ("cpu", cuda):
        bt = {k: v.to(dev) for k, v in batch.items()}
        dr = {k: v.to(dev) for k, v in draws.items()}
        gm, dm = copy.deepcopy(vits).to(dev), copy.deepcopy(disc).to(dev)
        with torch.no_grad():
            attn = gm.train_forward(bt["phones"], bt["phone_mask"], bt["spec"], bt["spec_mask"],
                                    **dr)["attn"].cpu()
        n = MEL.launches
        gs, ds = create_vits_states(gm, dm, GANTrainConfig())
        _, _, met = make_vits_train_step(MelConfig(), GANTrainConfig())(gs, ds, bt, dr)
        if str(dev) != "cpu":
            torch.cuda.synchronize()
            assert MEL.launches == n + 2
        res[str(dev)] = ({k: v.item() for k, v in met.items()}, attn)
    (ref, attn_ref), (got, attn_got) = res["cpu"], res["cuda"]
    assert torch.equal(attn_got, attn_ref)
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-3 * abs(v), (k, got[k], v)
