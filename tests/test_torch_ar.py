"""PyTorch port, the Vevo AR decode: `LlamaDecoder` prefill and steps through
both KV caches, `ARTransformer`, the fixed-shape and ragged generate loops
and the samplers, against the JAX package on the CPU (Pallas kernels in
interpret mode), with the JAX weights carried over by `from_flax`.

Tolerances: float32 greedy tokens exact (fixed-shape and ragged decode);
bf16, int8 and int4 teacher-forced logits within 3e-2 of max|logit| (bf16
rounds at other places in the two frameworks). The port
quantizes its own weights (`prepare_for_decode`), JAX its own
(`_quantize_for_decode`): tests/test_torch_quant.py holds the two
bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.models.vc.ar_transformer import ARTransformer as JAR
from amphion_tpu.models.vc.ar_transformer import ARTransformerConfig as JARConfig
from amphion_tpu.models.vc.ar_transformer import _quantize_for_decode
from amphion_tpu.models.vc.ar_transformer import ar_transformer_generate as jax_generate
from amphion_tpu.models.vc.ar_transformer import (
    ar_transformer_generate_ragged as jax_generate_ragged,
)
from amphion_tpu.modules.llama import LlamaDecoder as JLlamaDecoder
from amphion_tpu.ops.ragged import pack_segments_right as jax_pack_right
from amphion_tpu.ops.ragged import right_pack_valid as jax_right_valid
from amphion_tpu.ops.sampling import top_k_filter as jax_top_k
from amphion_tpu.ops.sampling import top_p_filter as jax_top_p
from amphion_tpu_torch.models.vc.ar_transformer import (
    DECODE_DTYPES,
    ARTransformer,
    ARTransformerConfig,
    ar_transformer_generate,
    ar_transformer_generate_ragged,
    prepare_for_decode,
)
from amphion_tpu_torch.modules.llama import LlamaConfig
from amphion_tpu_torch.ops import ragged as tragged
from amphion_tpu_torch.ops.sampling import sample_logits, top_k_filter, top_p_filter
from amphion_tpu_torch.utils.convert import from_flax

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)


T = torch.from_numpy
AR = dict(input_vocab=8, output_vocab=48, hidden=64, intermediate=128, num_layers=2,
          num_heads=4, max_position=128)


@pytest.fixture(scope="module")
def ar_pair():
    jm = JAR(JARConfig(**AR))
    toks = jnp.zeros((1, 5), jnp.int32)
    # every leaf random (Flax's shapes, traced by ``jax.eval_shape``, not compiled):
    # kernels normal over sqrt(fan_in), embeddings over sqrt(features), norm scales
    # (Flax's ones) uniform in [0.5, 1.5], the rest 0.1 normal
    shapes = jax.eval_shape(functools.partial(jm.init, method=JAR.forward), jax.random.key(0),
                            toks, jnp.ones((1, 5)), toks, jnp.ones((1, 5)))["params"]
    rng = np.random.default_rng(3)

    def leaf(path, s):
        name = path[-1].key
        adaptive = len(path) > 1 and path[-2].key == "to_weight"
        if name == "scale" or (adaptive and name == "bias"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        std = ((0.2 if adaptive else 1.0) / np.sqrt(np.prod(s.shape[:-1])) if name == "kernel"
               else 1.0 / np.sqrt(s.shape[-1]) if name == "embedding" else 0.1)
        return (std * rng.standard_normal(s.shape)).astype(np.float32)
    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jm, params


def _port(params, dtype):
    return prepare_for_decode(from_flax(ARTransformer(ARTransformerConfig(**AR)), params),
                              dtype)


@functools.lru_cache(maxsize=None)
def _jax_teacher(jm, dtype, steps, kv_quant_env, fused_env):
    """JAX prefill + ``steps`` teacher-forced steps, jitted; (steps+1, B, V)."""
    def run(params, inp, pout, forced):
        model, qp, dt = _quantize_for_decode(jm, params, dtype)
        b = inp.shape[0]
        total = inp.shape[1] + 3 + pout.shape[1] + steps
        caches = JLlamaDecoder(model.cfg.llama()).init_cache(b, total, dtype=dt)
        logits, caches, pl = model.apply({"params": qp}, inp, caches, None, pout,
                                         method=JAR.prefill)
        outs = [logits]
        for i in range(steps):
            logits, caches = model.apply({"params": qp}, forced[:, i], caches, pl + i,
                                         method=JAR.step)
            outs.append(logits)
        return jnp.stack(outs).astype(jnp.float32)

    return jax.jit(run)


def _port_teacher(model, dtype, inp, pout, forced):
    b = inp.shape[0]
    total = inp.shape[1] + 3 + pout.shape[1] + forced.shape[1]
    caches = model.decoder.init_cache(b, total, DECODE_DTYPES[dtype], torch.device("cpu"))
    with torch.inference_mode():
        logits, caches, pl = model.prefill(inp, caches, pout)
        outs = [logits]
        for i in range(forced.shape[1]):
            logits, caches = model.step(forced[:, i], caches, pl + i)
            outs.append(logits)
    return torch.stack(outs).float().numpy()


CASES = [  # dtype, AMPHION_KV_QUANT, AMPHION_FUSED_DECODE_ATTN, AMPHION_FUSED_RMS, tol
    ("bfloat16", "1", "", "0", 3e-2),
    ("int8", "1", "", "0", 3e-2),
    ("int4", "1", "1", "1", 3e-2),
]


@pytest.mark.parametrize("dtype,kvq,fused_attn,fused_rms,tol", CASES)
def test_teacher_forced_logits_match_jax(ar_pair, monkeypatch, dtype, kvq, fused_attn,
                                         fused_rms, tol):
    """Prefill + a step through the dense bf16 cache or the int8
    head-major cache; the int4 case takes
    kernel 8 (AMPHION_FUSED_DECODE_ATTN) and kernel 5's RMSNorm prologue
    (AMPHION_FUSED_RMS) on both sides, with its o and down projections
    through kernel 5 without the prologue."""
    jm, params = ar_pair
    monkeypatch.setenv("AMPHION_KV_QUANT", kvq)
    monkeypatch.setenv("AMPHION_FUSED_RMS", fused_rms)
    if fused_attn:
        monkeypatch.setenv("AMPHION_FUSED_DECODE_ATTN", fused_attn)
    else:
        monkeypatch.delenv("AMPHION_FUSED_DECODE_ATTN", raising=False)
    rng = np.random.default_rng(4)
    inp = rng.integers(0, 8, (2, 6)).astype(np.int32)
    pout = rng.integers(0, 48, (2, 3)).astype(np.int32)
    forced = rng.integers(0, 48, (2, 1)).astype(np.int32)
    ref = np.asarray(_jax_teacher(jm, dtype, 1, kvq, fused_attn + fused_rms)(
        params, inp, pout, forced))
    model = _port(params, dtype)
    assert model.cfg.kv_quant == (dtype in ("int8", "int4") and kvq == "1")
    out = _port_teacher(model, dtype, T(inp).long(), T(pout).long(), T(forced).long())
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max(), np.abs(out - ref).max()


def test_greedy_generate_matches_jax_exactly(ar_pair):
    jm, params = ar_pair
    inp = np.random.default_rng(5).integers(0, 8, (2, 7)).astype(np.int32)
    jt, jn = jax_generate(jm, params, jnp.asarray(inp), jax.random.key(0), max_new=10,
                          temperature=0.0, compute_dtype="float32")
    tt, tn = ar_transformer_generate(_port(params, "float32"), T(inp), None, max_new=10,
                                     temperature=0.0, compute_dtype="float32")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_greedy_ragged_generate_matches_jax_exactly(ar_pair):
    """Right-packed ragged prefill with an output-stream prompt, pad slots
    masked by ``kv_valid``: the serving decode."""
    jm, params = ar_pair
    rng = np.random.default_rng(6)
    content = rng.integers(0, 8, (3, 9)).astype(np.int32)
    clen = np.array([9, 4, 6], np.int32)
    pout = rng.integers(0, 48, (3, 5)).astype(np.int32)
    plen = np.array([2, 5, 1], np.int32)
    keys = jax.vmap(jax.random.key)(jnp.arange(3, dtype=jnp.uint32))
    jt, jn = jax_generate_ragged(jm, params, content, clen, keys, max_new=8,
                                 temperature=0.0, prompt_output_tokens=pout,
                                 prompt_output_len=plen, compute_dtype="float32")
    tt, tn = ar_transformer_generate_ragged(
        _port(params, "float32"), T(content), T(clen), None, max_new=8, temperature=0.0,
        prompt_output_tokens=T(pout), prompt_output_len=T(plen), compute_dtype="float32")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_generate_checks_the_prepared_dtype(ar_pair):
    _, params = ar_pair
    model = _port(params, "int8")
    assert model.cfg.decode_quant == "int8" and model.embed_tokens.weight.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="prepare it once"):
        ar_transformer_generate(model, torch.zeros((1, 3), dtype=torch.long), max_new=1,
                                compute_dtype="int4")


def test_right_packing_matches_jax():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 50, (3, 6)).astype(np.int32)
    b = rng.integers(0, 50, (3, 4)).astype(np.int32)
    la, lb = np.array([6, 2, 4], np.int32), np.array([1, 4, 3], np.int32)
    ref, vref = jax.jit(lambda a, b, la, lb: (  # one program, not op by op
        jax_pack_right([a, b], [la, lb]), jax_right_valid([la, lb], 10, 14)))(a, b, la, lb)
    out = tragged.pack_segments_right([T(a), T(b)], [T(la), T(lb)])
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    vout = tragged.right_pack_valid([T(la), T(lb)], 10, 14)
    np.testing.assert_array_equal(vout.numpy(), np.asarray(vref))


def test_sampling_filters_match_jax_and_draws_follow_generators():
    logits = np.random.default_rng(8).standard_normal((3, 50)).astype(np.float32)
    # JAX's filters, all in one program (eager JAX dispatches op by op)
    want = jax.jit(lambda x: ([jax_top_k(x, k) for k in (0, 5, 50)],
                              [jax_top_p(x, p) for p in (0.3, 0.9, 1.0)]))(logits)
    for k, w in zip((0, 5, 50), want[0]):
        np.testing.assert_array_equal(top_k_filter(T(logits), k).numpy(), np.asarray(w))
    for p, w in zip((0.3, 0.9, 1.0), want[1]):
        np.testing.assert_array_equal(top_p_filter(T(logits), p).numpy(), np.asarray(w))
    lg = T(logits)
    assert (sample_logits(lg, None, 0.0) == lg.argmax(-1)).all()
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
    first = sample_logits(lg, gens, 1.0, top_k=5)
    kth = torch.topk(lg, 5).values[:, -1]
    assert (lg.gather(1, first[:, None])[:, 0] >= kth).all()  # inside the top 5
    # a row's draw depends on its own generator only
    again = sample_logits(lg[1:2], [torch.Generator().manual_seed(2)], 1.0, top_k=5)
    assert again[0] == first[1]
    with pytest.raises(ValueError, match="generators"):
        sample_logits(lg, gens[:2], 1.0)


def test_llama_config_accepts_quantized_decode():
    assert LlamaConfig(decode_quant="int4", kv_quant=True).kv_quant
