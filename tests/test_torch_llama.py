"""PyTorch port, modules and models: the adaptive Llama encoder, the RepCodec
style tokenizer and the Vocos vocoder against the JAX package on the CPU,
with the JAX weights carried over by `utils/convert.from_flax`.

Tolerances: 1e-4 absolute in float32; 3e-2 in bfloat16; tokens exact.
Traps these tests hold the port to: RepCodec's GELU is the tanh form (the
``jax.nn.gelu`` default) while Vocos's is exact; Flax LayerNorm's eps is
1e-6, not torch's 1e-5; Flax convolutions pad ``"SAME"``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.models.codec.repcodec import RepCodec as JRepCodec
from amphion_tpu.models.codec.repcodec import RepCodecConfig as JRepCodecConfig
from amphion_tpu.models.vocoders.vocos import VocosConfig as JVocosConfig
from amphion_tpu.models.vocoders.vocos import VocosGenerator as JVocos
from amphion_tpu.modules.llama import LlamaConfig as JLlamaConfig
from amphion_tpu.modules.llama import LlamaEncoder as JLlamaEncoder
from amphion_tpu.modules.llama import rotary_tables as jax_rotary_tables
from amphion_tpu_torch.models.codec.repcodec import RepCodec, RepCodecConfig
from amphion_tpu_torch.models.vocoders.vocos import VocosConfig, VocosGenerator
from amphion_tpu_torch.modules.llama import LlamaConfig, LlamaEncoder, rotary_tables
from amphion_tpu_torch.utils.convert import from_flax

T = torch.from_numpy


def jinit(module, *args, **kw):
    """Flax ``init`` under one jit (much faster on the CPU than op by op)."""
    return jax.jit(functools.partial(module.init, **kw))(*args)["params"]


def japply(module, params, *args, **kw):
    return np.asarray(jax.jit(functools.partial(module.apply, **kw))(
        {"params": params}, *args))


def _perturb(tree, seed, scale=0.2):
    """Randomise every leaf, so identity-initialised parts (adaptive-norm
    projections, ConvNeXt gamma) are exercised too."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.standard_normal(p.shape).astype(np.float32),
        jax.device_get(tree))


@pytest.fixture(scope="module")
def encoder_setup():
    cfg = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
               adaptive=True, max_position=64)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    cond = rng.standard_normal((2, 64)).astype(np.float32)
    mask = np.ones((2, 24), np.float32)
    mask[1, 17:] = 0.0
    jenc = JLlamaEncoder(JLlamaConfig(**cfg, use_flash=False))
    params = _perturb(jinit(jenc, jax.random.key(0), jnp.asarray(x), jnp.asarray(cond),
                            jnp.asarray(mask)), 2, scale=0.05)
    enc = from_flax(LlamaEncoder(LlamaConfig(**cfg)), params)
    return cfg, params, enc, x, cond, mask


@pytest.mark.parametrize("use_flash", [True, False])
def test_llama_encoder_matches_jax(encoder_setup, use_flash):
    """JAX with the Pallas flash kernel (interpret) and with dense attention;
    the port always takes its flash wrapper (plain version on the CPU)."""
    cfg, params, enc, x, cond, mask = encoder_setup
    jenc = JLlamaEncoder(JLlamaConfig(**cfg, use_flash=use_flash))
    ref = japply(jenc, params, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mask))
    with torch.no_grad():
        out = enc(T(x), T(cond), T(mask)).numpy()
    valid = mask > 0
    np.testing.assert_allclose(out[valid], ref[valid], atol=1e-4)


def test_llama_encoder_bf16_matches_jax(encoder_setup):
    cfg, params, enc, x, cond, mask = encoder_setup
    jenc = JLlamaEncoder(JLlamaConfig(**cfg, use_flash=False))
    bf = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.bfloat16), params)
    ref = japply(jenc, bf, jnp.asarray(x, jnp.bfloat16), jnp.asarray(cond, jnp.bfloat16),
                 jnp.asarray(mask)).astype(np.float32)
    enc16 = from_flax(LlamaEncoder(LlamaConfig(**cfg)), params).to(torch.bfloat16)
    with torch.no_grad():
        out = enc16(T(x).bfloat16(), T(cond).bfloat16(), T(mask)).float().numpy()
    valid = mask > 0
    err = np.abs(out[valid] - ref[valid]).max()
    assert err <= 3e-2 * np.abs(ref[valid]).max(), err


def test_rotary_tables_match_jax():
    for got, want in zip(rotary_tables(300, 64, 1e4), jax_rotary_tables(300, 64, 1e4)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_llama_config_rejects_quantized_decode():
    """Only the quantizations the kernels take: none, int8, int4."""
    with pytest.raises(ValueError, match="decode_quant"):
        LlamaConfig(decode_quant="int2")
    with pytest.raises(ValueError, match="decode_quant"):
        LlamaConfig(decode_quant="fp8", kv_quant=True)


def test_repcodec_tokens_match_jax_exactly():
    jcfg = JRepCodecConfig(feature_dim=16, hidden=32, codebook_size=64,
                           codebook_dim=4, num_blocks=2)
    feats = np.random.default_rng(3).standard_normal((2, 50, 16)).astype(np.float32)
    jm = JRepCodec(jcfg)
    params = _perturb(jinit(jm, jax.random.key(1), jnp.asarray(feats)), 4)
    ref = japply(jm, params, jnp.asarray(feats), method="encode")
    cfg = RepCodecConfig(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(RepCodecConfig)})
    out = from_flax(RepCodec(cfg), params).encode(T(feats))
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), ref)
    assert len(np.unique(ref)) > 8  # the lookup is not degenerate


def test_vocos_with_frame_lengths_matches_jax():
    kw = dict(n_mel=8, dim=32, intermediate_dim=48, num_layers=2, n_fft=64, hop_size=24)
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((2, 30, 8)).astype(np.float32)
    lens = np.array([30, 19], np.int32)
    jm = JVocos(JVocosConfig(**kw))
    params = _perturb(jinit(jm, jax.random.key(2), jnp.asarray(mel)), 6)
    ref = japply(jm, params, jnp.asarray(mel), jnp.asarray(lens))
    out = from_flax(VocosGenerator(VocosConfig(**kw)), params)(T(mel), T(lens)).numpy()
    assert out.shape == ref.shape == (2, 30 * 24)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(out[i, : n * 24], ref[i, : n * 24], atol=1e-4)


def test_from_flax_rejects_missing_and_misshapen_leaves():
    lin = torch.nn.Linear(3, 4)
    with pytest.raises(KeyError):
        from_flax(lin, {"bias": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        from_flax(lin, {"kernel": np.zeros((3, 5), np.float32),
                        "bias": np.zeros(4, np.float32)})
    kernel = np.arange(12, dtype=np.float32).reshape(3, 4)
    from_flax(lin, {"kernel": kernel, "bias": np.ones(4, np.float32)})
    np.testing.assert_array_equal(lin.weight.detach().numpy(), kernel.T)
