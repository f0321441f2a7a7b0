"""PyTorch port, codec-LM training: the VALL-E and MaskGCT losses and their
gradients against the JAX package on the CPU, and `LengthBucketSampler`'s
batches against JAX's.

The same numpy inputs and, through `utils/convert.from_flax`, the same
weights (random leaves in the Flax init's shapes, from ``jax.eval_shape``)
go to both. The JAX losses split their key as in
`amphion_tpu/models/tts/{valle/valle.py,maskgct/maskgct.py}`; the test
draws from the same splits and hands the port the draws. Tolerances:
losses 1e-4 absolute, T2S accuracy equal, every gradient within 1e-4 of
its tensor's max|g|. JAX's side is compiled with most XLA optimizations
off (`quick_xla`): the same programs, about a third less compile time.
"""

import contextlib
import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.data.samplers import LengthBucketSampler as JLengthBucketSampler
from amphion_tpu.models.tts.maskgct.maskgct import MaskGCTS2A as JS2A
from amphion_tpu.models.tts.maskgct.maskgct import MaskGCTT2S as JT2S
from amphion_tpu.models.tts.maskgct.maskgct import S2AConfig as JS2AConfig
from amphion_tpu.models.tts.maskgct.maskgct import T2SConfig as JT2SConfig
from amphion_tpu.models.tts.valle.valle import VALLE as JVALLE
from amphion_tpu.models.tts.valle.valle import VALLEConfig as JVALLEConfig
from amphion_tpu_torch.data.samplers import LengthBucketSampler
from amphion_tpu_torch.models.tts.maskgct.maskgct import (
    MaskGCTS2A,
    MaskGCTT2S,
    S2AConfig,
    T2SConfig,
)
from amphion_tpu_torch.models.tts.valle.valle import VALLE, VALLEConfig
from amphion_tpu_torch.utils.convert import _flax_leaf, from_flax

torch.set_num_threads(1)  # one xdist worker per core

T = torch.from_numpy
SMALL = dict(hidden=64, num_layers=2, num_heads=4)


@contextlib.contextmanager
def quick_xla():
    """Compile JAX's programs with most XLA optimizations off (tiny shapes:
    compiling, not running, is the cost), restoring the setting after."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", old)


@pytest.fixture(scope="module", autouse=True)
def _quick_xla():
    with quick_xla():
        yield


def random_tree(module, seed, *args, method=None):
    """A Flax tree of ``module``'s init shapes (``jax.eval_shape``: traced,
    not compiled) with random leaves: norm scales and the adaptive norms'
    biases near 1, the adaptive norms' kernels small, other kernels normal
    over √fan_in, embeddings over √features, the rest 0.1 normal."""
    rng = np.random.default_rng(seed)
    # Flax's own init, also where a test has replaced the class's
    init = functools.partial(flax.linen.Module.init, module, method=method)
    shapes = jax.eval_shape(init, jax.random.key(0), *args)["params"]

    def leaf(path, s):
        name = path[-1].key
        adaptive = len(path) > 1 and path[-2].key == "to_weight"
        if name == "scale" or (adaptive and name == "bias"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        std = ((0.2 if adaptive else 1.0) / np.sqrt(np.prod(s.shape[:-1])) if name == "kernel"
               else 1.0 / np.sqrt(s.shape[-1]) if name in ("embedding", "mask_emb") else 0.1)
        return (std * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def assert_grads_match(module, jgrads):
    """Each port gradient within 1e-4 of max|g| of its Flax leaf."""
    n = 0
    for mname, sub in module.named_modules():
        path = mname.split(".") if mname else []
        for pname, p in sub.named_parameters(recurse=False):
            ref = np.asarray(_flax_leaf(sub, jgrads, path, pname))
            got = p.grad.numpy() if p.grad is not None else np.zeros_like(ref)
            scale = max(np.abs(ref).max(), 1e-12)
            err = np.abs(got - ref).max()
            assert err <= 1e-4 * scale, f"{mname}.{pname}: {err:.3g} > 1e-4 x {scale:.3g}"
            n += 1
    assert n == len(list(module.parameters()))


@functools.cache
def value_and_grad(model, method):
    """JAX's loss, aux and gradients, jitted (the key as an argument); one
    function for equal modules, so cases that differ only in their inputs
    share its compile."""
    @jax.jit
    def run(params, *args):
        def f(p):
            return model.apply({"params": p}, *args, method=method)
        return jax.value_and_grad(f, has_aux=True)(params)
    return run


# -- VALL-E -------------------------------------------------------------------------


def valle_batch(seed, q=3, vocab=16, n_phones=40):
    """Phones with padding holes (a row's padded phones sit between its real
    phones and its codes), codes with ragged lengths."""
    rng = np.random.default_rng(seed)
    b, lp, t = 3, 9, 24
    ph_len, tok_len = np.array([9, 5, 7]), np.array([24, 17, 20])
    phones = rng.integers(1, n_phones, (b, lp)).astype(np.int32)
    tokens = rng.integers(0, vocab, (b, q, t)).astype(np.int32)
    pm = (np.arange(lp)[None] < ph_len[:, None]).astype(np.float32)
    tm = (np.arange(t)[None] < tok_len[:, None]).astype(np.float32)
    return phones * pm.astype(np.int32), pm, tokens, tm


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _valle_keys(key, b, q, low):
    rng, rng_p = jax.random.split(key)
    return (jax.random.randint(rng, (b,), 1, q),
            jax.random.randint(rng_p, (), 0, max(low, 1)))


def valle_draws(cfg, token_mask, key):
    """The JAX `VALLE.train_loss` draws from ``key``: (stage, plen); one
    jitted program, not an eager compile a draw."""
    low = int(0.25 * token_mask.sum(1).min())
    stage, r = _valle_keys(key, token_mask.shape[0], cfg.num_quantizers, low)
    return np.asarray(stage), min(int(r) + low, cfg.max_prefix_len)


@pytest.mark.parametrize("prefix_mode", [1, 0])
def test_valle_train_loss_and_grads_match_jax(prefix_mode):
    kw = dict(num_phones=40, audio_vocab=16, num_quantizers=3, max_position=64,
              prefix_mode=prefix_mode, **SMALL)
    jcfg = JVALLEConfig(**kw)
    jm = JVALLE(jcfg)
    phones, pm, tokens, tm = valle_batch(3)
    key = jax.random.key(7)
    params = random_tree(jm, 11, phones, pm, tokens, tm, key, method=JVALLE.train_loss)
    (jloss, jaux), jgrads = value_and_grad(jm, JVALLE.train_loss)(params, phones, pm, tokens,
                                                                  tm, key)
    model = from_flax(VALLE(VALLEConfig(**kw)), params)
    stage, plen = valle_draws(jcfg, tm, key)
    loss, aux = model.train_loss(T(phones), T(pm), T(tokens), T(tm), stage=T(stage),
                                 plen=plen if prefix_mode == 1 else None)
    loss.backward()
    for k in ("ar_loss", "nar_loss"):
        assert abs(aux[k].item() - float(jaux[k])) <= 1e-4, (k, aux[k].item(), jaux[k])
    assert abs(loss.item() - float(jloss)) <= 1e-4
    assert_grads_match(model, jgrads)


def test_valle_draws_from_a_generator():
    """Without injected draws: stage in [1, Q), the prefix ``plen`` in
    [low, 2·low) on real positions only, and the same draws from the same
    seed."""
    model = VALLE(VALLEConfig(num_phones=40, audio_vocab=16, num_quantizers=3, **SMALL))
    _, _, _, tm = valle_batch(3)
    tm = T(tm)
    low = int(0.25 * 17)
    seen = set()
    for s in range(20):
        stage, pmask = model.train_draws(tm, torch.Generator().manual_seed(s))
        again = model.train_draws(tm, torch.Generator().manual_seed(s))
        assert torch.equal(stage, again[0]) and torch.equal(pmask, again[1])
        assert ((stage >= 1) & (stage < 3)).all()
        plen = int(pmask[0].sum())
        assert low <= plen < 2 * low and (pmask <= tm).all()
        seen.add(plen)
    assert len(seen) > 1


# -- MaskGCT ------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _mask_keys(key, b, t_len, cond_drop_prob, s2a_q):
    keys = jax.random.split(key, 4 if s2a_q is None else 5)
    if s2a_q is None:
        r_t, r_mask, r_prompt, r_drop = keys
    else:
        r_t, r_mask, r_layer, r_prompt, r_drop = keys
    out = dict(t=jax.random.uniform(r_t, (b,)),
               mask_u=jax.random.uniform(r_mask, (b, t_len), jnp.float32),
               prompt_len=jax.random.randint(r_prompt, (b,), 0, max(1, int(t_len * 0.4))),
               use_cond=jax.random.uniform(r_drop, (b,)) > cond_drop_prob)
    if s2a_q is not None:
        out["layer"] = jax.random.randint(r_layer, (b,), 0, s2a_q)
    return out


def mask_draws(key, b, t_len, cond_drop_prob=0.2, s2a_q=None):
    """The draws of JAX's ``compute_loss`` from ``key`` (T2S: four splits;
    S2A: five, the layer third) as the port's keywords; one jitted
    program."""
    return {k: T(np.array(v))
            for k, v in _mask_keys(key, b, t_len, cond_drop_prob, s2a_q).items()}


def mg_batch(seed, vocab):
    rng = np.random.default_rng(seed)
    b, lp, t = 3, 8, 20
    ph_len, x_len = np.array([8, 4, 6]), np.array([20, 13, 16])
    pm = (np.arange(lp)[None] < ph_len[:, None]).astype(np.float32)
    xm = (np.arange(t)[None] < x_len[:, None]).astype(np.float32)
    phones = (rng.integers(1, 40, (b, lp)) * pm).astype(np.int32)
    x0 = rng.integers(0, vocab, (b, t)).astype(np.int32)
    return phones, pm, x0, xm


@pytest.mark.parametrize("key_seed,dropped", [(0, False), (5, True)])
def test_t2s_compute_loss_and_grads_match_jax(key_seed, dropped):
    """With and without a row whose prompt and phones are dropped."""
    kw = dict(codebook_size=32, phone_vocab=40, max_position=64, **SMALL)
    jm = JT2S(JT2SConfig(**kw))
    phones, pm, x0, xm = mg_batch(4, 32)
    key = jax.random.key(key_seed)
    draws = mask_draws(key, *x0.shape)
    assert bool((~draws["use_cond"]).any()) == dropped  # the key gives the case asked for
    params = random_tree(jm, 12, x0, xm, phones, pm, key, method=JT2S.compute_loss)
    (jloss, jaux), jgrads = value_and_grad(jm, JT2S.compute_loss)(params, x0, xm, phones, pm,
                                                                  key)
    model = from_flax(MaskGCTT2S(T2SConfig(**kw)), params)
    loss, aux = model.compute_loss(T(x0), T(xm), T(phones), T(pm), **draws)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-4
    assert aux["t2s_acc"].item() == float(jaux["t2s_acc"])
    assert_grads_match(model, jgrads)


def test_s2a_compute_loss_and_grads_match_jax():
    """The mel-proxy S2A (conditioned on float features: ``sem_proj``, no
    ``cond_emb``, as Flax creates it from such an init)."""
    kw = dict(codebook_size=16, num_quantizers=3, semantic_dim=12, max_position=64, **SMALL)
    jm = JS2A(JS2AConfig(**kw))
    _, _, x0, xm = mg_batch(6, 16)
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 16, (3, 3, x0.shape[1])).astype(np.int32)
    feats = rng.standard_normal((3, x0.shape[1], 12)).astype(np.float32)
    key = jax.random.key(3)
    params = random_tree(jm, 13, codes, xm, feats, key, method=JS2A.compute_loss)
    assert "cond_emb" not in params and "sem_proj" in params
    (jloss, _), jgrads = value_and_grad(jm, JS2A.compute_loss)(params, codes, xm, feats, key)
    model = from_flax(MaskGCTS2A(S2AConfig(**kw), token_cond=False, feature_cond=True), params)
    draws = mask_draws(key, 3, x0.shape[1], s2a_q=3)
    assert len(set(draws["layer"].tolist())) > 1  # rows on different heads
    loss, _ = model.compute_loss(T(codes), T(xm), T(feats), **draws)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-4
    assert_grads_match(model, jgrads)


# -- the sampler --------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 1234])
def test_length_bucket_sampler_matches_jax(seed):
    """Three passes (epochs) of batches, (indices, bucket) in order, and
    the length."""
    lengths = np.random.default_rng(seed).integers(20, 700, 150).tolist()
    kw = dict(max_tokens=2000, min_bucket=64, seed=seed)
    ours, ref = LengthBucketSampler(lengths, **kw), JLengthBucketSampler(lengths, **kw)
    assert len(ours) == len(ref)
    for _ in range(3):
        assert list(ours) == list(ref)
