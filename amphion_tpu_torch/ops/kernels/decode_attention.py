"""Single-query attention over the int8 KV cache: kernel 8
(`csrc/decode_attn_int8.cu`) and its plain version.

Port of `decode_attention_int8` (amphion_tpu/ops/pallas_kernels.py:1150-1223).
Layout is the head-major int8 cache of `modules/llama.LlamaDecoder`:
q (B, H, D) float32 (rotary applied, unscaled), ck/cv (B, H, S, D) int8,
ks/vs (B, H, S) float32 per-(position, head) scales, valid_len (B,) int32.
Per (b, h): scores ``q · k_int · ks / √D`` (the scale applied after the
dot), ``-inf`` at positions ≥ valid_len, a float32 softmax, and
``Σ p · vs · v_int`` → (B, H, D) float32.

On a CUDA tensor `decode_attention_int8` launches the kernel; on a CPU
tensor it runs `decode_attention_int8_ref`.
"""

from __future__ import annotations

import math

import torch

from amphion_tpu_torch.ops.kernels._build import Fl, I, Kernel, P, no_backward

DECODE_ATTN = Kernel("decode_attn_int8",
                     {"decode_attn_int8": [P, P, P, P, P, P, P, P, I, I, I, I, I, Fl, P]})
SPLIT = 256  # cache positions per block of the kernel's first pass


def decode_attention_int8_ref(q, ck, cv, ks, vs, valid_len):
    """Plain version, the Pallas kernel's arithmetic in float32."""
    d = q.shape[-1]
    s = torch.einsum("bhd,bhsd->bhs", q.float(), ck.float())
    s = s * ks.float() / math.sqrt(d)
    pos = torch.arange(ck.shape[2], device=q.device)
    s = s.masked_fill(pos[None, None, :] >= valid_len.to(q.device)[:, None, None],
                      float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p * vs.float(), cv.float())


def decode_attention_int8(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                          ks: torch.Tensor, vs: torch.Tensor,
                          valid_len: torch.Tensor) -> torch.Tensor:
    """Fused single-step decode attention → (B, H, D) float32.

    The kernel splits each (b, h) row of the cache over blocks of `SPLIT`
    positions (flash-decoding): each block writes its partial max, sum and
    weighted V-sum, and a second pass combines them."""
    b, h, d = q.shape
    if ck.ndim != 4 or ck.shape[:2] != (b, h) or ck.shape[3] != d or cv.shape != ck.shape:
        raise ValueError(f"decode_attention_int8 shapes q {tuple(q.shape)} "
                         f"ck {tuple(ck.shape)} cv {tuple(cv.shape)}")
    s_len = ck.shape[2]
    if ks.shape != ck.shape[:3] or vs.shape != ck.shape[:3] or tuple(valid_len.shape) != (b,):
        raise ValueError(f"scales must be {tuple(ck.shape[:3])} and valid_len ({b},)")
    if q.device.type == "cpu":
        return decode_attention_int8_ref(q, ck, cv, ks, vs, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8 runs on cuda or cpu, not {q.device}")
    no_backward("decode_attention_int8", q, ks, vs)
    if d != 64 and d != 128:
        raise ValueError(f"decode_attention_int8 kernel takes head dim 64 or 128, got {d}")
    if (q.dtype != torch.float32 or ck.dtype != torch.int8 or cv.dtype != torch.int8
            or ks.dtype != torch.float32 or vs.dtype != torch.float32):
        raise ValueError("decode_attention_int8 takes float32 q and scales, int8 cache")
    q = q.contiguous()
    lens = valid_len.to(device=q.device, dtype=torch.int32).contiguous()
    for name, t in (("ck", ck), ("cv", cv), ("ks", ks), ("vs", vs)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    n_split = max(1, -(-s_len // SPLIT))
    part = torch.empty((b * h, n_split, d + 2), dtype=torch.float32, device=q.device)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    DECODE_ATTN.launch("decode_attn_int8", q.data_ptr(), ck.data_ptr(), cv.data_ptr(),
                       ks.data_ptr(), vs.data_ptr(), lens.data_ptr(), part.data_ptr(),
                       out.data_ptr(), b, h, s_len, d, n_split,
                       1.0 / math.sqrt(d), stream)
    return out
