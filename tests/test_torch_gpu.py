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
