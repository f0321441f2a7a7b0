"""PyTorch port, weight-only quantization: the int8/int4 quantizers, the plain
versions of kernels 4 (int8 matmul), 5 (int4 matmul, with and without its
RMSNorm prologue) and 8 (int8 decode attention), the quantized state of a
Llama stack and the weight bridge for quantized trees, against the JAX
package on the CPU (Pallas kernels in interpret mode, as tests/test_pallas.py
runs them).

Inputs come from a numpy seed. Quantized integers and scales must be
bit-equal to JAX's. Kernel outputs agree within 1e-5 of max|ref|: both sum
the same bf16-rounded products in float32, in another order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.modules.llama import LlamaConfig as JLlamaConfig
from amphion_tpu.modules.llama import LlamaDecoder as JLlamaDecoder
from amphion_tpu.modules.llama import quantize_llama_params as jax_quantize_llama
from amphion_tpu.ops.pallas_kernels import (
    decode_attention_int8 as jax_decode_attention_int8,
    int4_matmul_pallas,
    int8_matmul_pallas,
    quantize_weight_int4 as jax_quantize_int4,
    quantize_weight_int8 as jax_quantize_int8,
)
from amphion_tpu_torch.modules.llama import (
    LlamaConfig,
    LlamaDecoder,
    _q8,
    cast_params,
    int4_group,
    quantize_llama_params,
    validate_quantized_tree,
)
from amphion_tpu_torch.ops.kernels.decode_attention import decode_attention_int8
from amphion_tpu_torch.ops.kernels.int4_matmul import (
    int4_matmul,
    pack_int4,
    quantize_weight_int4,
    unpack_int4,
)
from amphion_tpu_torch.ops.kernels.int8_matmul import int8_matmul, quantize_weight_int8
from amphion_tpu_torch.utils.convert import from_flax

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)


T = torch.from_numpy


def _close(out, ref, rel=1e-5):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= rel * np.abs(ref).max(), np.abs(out - ref).max()


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_quantize_int8_bit_equal_to_jax(dtype):
    """Against the jitted JAX quantizer, as the decode path runs it on
    bf16 weights: integers from bf16 arithmetic, the float32 scale that XLA
    leaves (``/ 127`` as a multiply by float32(1/127), not rounded)."""
    w = np.random.default_rng(0).standard_normal((256, 96)).astype(np.float32) * 0.05
    w[:, 3] = 0.0  # an all-zero column takes the 1e-8 floor
    jq, js = jax.jit(jax_quantize_int8)(jnp.asarray(w, dtype))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tq, ts = quantize_weight_int8(T(np.ascontiguousarray(w.T)).to(tdt))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32


@pytest.mark.parametrize("group", [128, 32])
def test_quantize_int4_bit_equal_to_jax_and_packing_roundtrips(group):
    w = np.random.default_rng(1).standard_normal((256, 80)).astype(np.float32) * 0.05
    wb = jnp.asarray(w, jnp.bfloat16)
    jq, js = jax.jit(functools.partial(jax_quantize_int4, group=group))(wb)
    jint = np.asarray(jq).astype(np.int8)
    tq, ts = quantize_weight_int4(T(np.ascontiguousarray(w.T)).bfloat16(), group)
    np.testing.assert_array_equal(tq.numpy(), jint.T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    packed = pack_int4(tq)
    assert packed.dtype == torch.uint8 and packed.shape == (80, 128)
    np.testing.assert_array_equal(unpack_int4(packed).numpy(), jint.T)
    # low nibble = even k, high nibble = odd k, two's complement
    assert (packed.numpy() & 0xF == (jint.T[:, 0::2] & 0xF)).all()


def test_int4_group_matches_jax():
    from amphion_tpu.modules.llama import int4_group as jax_int4_group

    for k in (1280, 4096, 1024, 96, 40, 6):
        assert int4_group(k) == jax_int4_group(k)


@pytest.mark.parametrize("m", [4])
def test_int8_matmul_plain_matches_pallas(m):
    rng = np.random.default_rng(2 + m)
    x = rng.standard_normal((m, 128)).astype(np.float32)
    w = jnp.asarray(rng.standard_normal((128, 96)).astype(np.float32) * 0.05, jnp.bfloat16)
    jq, js = jax_quantize_int8(w)
    ref = int8_matmul_pallas(jnp.asarray(x), jq, js, block_n=32, block_k=64, interpret=True)
    out = int8_matmul(T(x), T(np.array(np.asarray(jq).T)), T(np.array(js)))
    _close(out.numpy(), ref)


@pytest.mark.parametrize("m,rms", [(4, False), (37, True)])
def test_int4_matmul_plain_matches_pallas(m, rms):
    """Two groups per row; with ``rms_scale`` the RMSNorm prologue
    (`_int4_matmul_rms_kernel`, whole K in one program)."""
    rng = np.random.default_rng(5 + m + rms)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    w = jnp.asarray(rng.standard_normal((256, 64)).astype(np.float32) * 0.05, jnp.bfloat16)
    g = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32) if rms else None
    jq, js = jax_quantize_int4(w, 128)
    ref = int4_matmul_pallas(jnp.asarray(x), jq, js, group=128, block_n=64,
                             block_k=256, rms_scale=None if g is None else jnp.asarray(g),
                             rms_eps=1e-6, interpret=True)
    w_p = pack_int4(T(np.ascontiguousarray(np.asarray(jq).astype(np.int8).T)))
    out = int4_matmul(T(x), w_p, T(np.array(js)), 128,
                      None if g is None else T(g), 1e-6)
    _close(out.numpy(), ref)


def test_decode_attention_int8_plain_matches_pallas():
    rng = np.random.default_rng(9)
    b, h, s, d = 2, 3, 40, 16
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    ck, cv = (rng.integers(-127, 128, (b, h, s, d)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.02, (b, h, s)).astype(np.float32) for _ in range(2))
    valid = np.array([17, 40], np.int32)
    ref = jax_decode_attention_int8(*(jnp.asarray(a) for a in (q, ck, cv, ks, vs, valid)),
                                    interpret=True)
    out = decode_attention_int8(*(T(a) for a in (q, ck, cv, ks, vs, valid)))
    _close(out.numpy(), ref)


def test_kernel_wrappers_reject_bad_input():
    x = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="int8"):
        int8_matmul(x, torch.zeros((8, 64)), torch.ones(8))
    with pytest.raises(ValueError, match="scale"):
        int4_matmul(x, torch.zeros((8, 32), dtype=torch.uint8), torch.ones(8), 32)
    with pytest.raises(ValueError, match="shapes"):
        decode_attention_int8(torch.zeros((1, 2, 8)), torch.zeros((1, 2, 5, 4), dtype=torch.int8),
                              torch.zeros((1, 2, 5, 4), dtype=torch.int8), torch.zeros((1, 2, 5)),
                              torch.zeros((1, 2, 5)), torch.ones(1, dtype=torch.int32))


@pytest.fixture(scope="module")
def decoder_tree():
    cfg = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
               max_position=64)
    x = np.zeros((1, 4, 64), np.float32)
    # Flax's shapes (traced by ``jax.eval_shape``, not compiled): kernels normal over
    # sqrt(fan_in), norm scales 1
    shapes = jax.eval_shape(JLlamaDecoder(JLlamaConfig(**cfg)).init, jax.random.key(0),
                            x)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
        if path[-1].key == "kernel" else np.ones(s.shape, np.float32), shapes)
    bf = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.bfloat16), params)
    return cfg, params, bf


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantize_llama_params_bit_equal_to_jax(decoder_tree, quant):
    """The port's quantized state (from the port's own bf16 state) against
    the JAX quantized tree carried over by `from_flax`, leaf by leaf."""
    cfg, params, bf = decoder_tree
    jtree = jax.jit(functools.partial(jax_quantize_llama, quant=quant))(bf)
    qcfg = LlamaConfig(**cfg, decode_quant=quant, kv_quant=True)
    bridged = from_flax(cast_params(LlamaDecoder(qcfg), torch.bfloat16), jtree)
    state = from_flax(LlamaDecoder(LlamaConfig(**cfg)), params).state_dict()
    ours = quantize_llama_params({k: v.bfloat16() for k, v in state.items()}, quant)
    theirs = bridged.state_dict()
    assert sorted(ours) == sorted(theirs)
    assert "layer_1.attn.qkv_proj.kernel_q" in ours and "layer_0.mlp.gateup_proj.scale" in ours
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k].float().numpy(), theirs[k].float().numpy(), k)
    validate_quantized_tree(ours, qcfg)
    with pytest.raises(ValueError, match="missing"):
        quantize_llama_params({k: v.bfloat16() for k, v in state.items()
                               if "layer_1.attn.k_proj" not in k}, quant)
    # JAX's unfused layout (separate q/k/v and gate/up) is refused at the
    # boundary: by the validator, and by the weight bridge
    unfused = jax.jit(functools.partial(jax_quantize_llama, quant=quant, fuse=False))(bf)
    flat = _flatten(unfused)
    assert "layer_0.attn.q_proj.kernel_q" in flat
    with pytest.raises(ValueError, match="UNFUSED"):
        validate_quantized_tree(flat, qcfg)
    with pytest.raises(KeyError, match="qkv_proj"):
        from_flax(cast_params(LlamaDecoder(qcfg), torch.bfloat16), unfused)


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


@jax.jit
def _jax_q8(x):
    """The int8 KV-cache quantizer of the JAX decoder, ``q8`` inside
    `amphion_tpu.modules.llama.LlamaAttention` (a closure there, so its body
    is repeated here), jitted as the decoder runs it."""
    x = jnp.swapaxes(x, 1, 2)
    s = jnp.max(jnp.abs(x), axis=-1) / 127.0
    s = jnp.maximum(s, 1e-8)
    return jnp.round(x / s[..., None]).astype(jnp.int8), s.astype(jnp.float32)


def test_kv_cache_q8_bit_equal_to_jax():
    """The port's int8 KV-cache integers and scales, bit for bit, over
    (B, T, H, D) rows of widely spread magnitudes, some all zero (the 1e-8
    floor)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 29, 5, 64)).astype(np.float32)
    x *= np.exp(rng.uniform(-12, 4, (3, 29, 5, 1))).astype(np.float32)
    x[0, :3] = 0.0
    q_j, s_j = _jax_q8(x)
    q_t, s_t = _q8(T(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
