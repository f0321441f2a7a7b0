"""PyTorch port, training slice: the flash-attention backward, the CFM and
AR losses with their gradients, the optimizer chain and the Flax
initializers, against the JAX package on the CPU.

The same numpy inputs and, through `utils/convert.from_flax`, the same
weights go to both; gradients are compared by Flax scope name. Tolerances:
losses 1e-5 relative; gradients 1e-4 absolute / 1e-3 relative; the
backward's plain version against the Pallas kernels in interpret mode
3e-4 / 1e-3 (the JAX test's own); optimizer parameters 1e-6. The JAX
random draws (flow time, noise) are taken from the same keys the JAX loss
splits and handed to the port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from amphion_tpu.models.codec.repcodec import RepCodec as JRepCodec
from amphion_tpu.models.codec.repcodec import RepCodecConfig as JRepCodecConfig
from amphion_tpu.models.vc.ar_transformer import ARTransformer as JAR
from amphion_tpu.models.vc.ar_transformer import ARTransformerConfig as JARConfig
from amphion_tpu.models.vc.flow_matching_transformer import FlowMatchingTransformer as JFM
from amphion_tpu.models.vc.flow_matching_transformer import FMTConfig as JFMTConfig
from amphion_tpu.modules.flow_matching import cfm_loss as jcfm_loss
from amphion_tpu.modules.flow_matching import cfm_pair as jcfm_pair
from amphion_tpu.ops.pallas_kernels import flash_attention as jflash
from amphion_tpu.ops.pallas_kernels import flash_attention_bwd_pallas, flash_attention_pallas
from amphion_tpu_torch.models.codec.repcodec import RepCodec, RepCodecConfig
from amphion_tpu_torch.models.vc.ar_transformer import ARTransformer, ARTransformerConfig
from amphion_tpu_torch.models.vc.flow_matching_transformer import (
    FlowMatchingTransformer,
    FMTConfig,
)
from amphion_tpu_torch.modules.flow_matching import cfm_loss, cfm_pair
from amphion_tpu_torch.ops.kernels.flash_attention import (
    FlashAttentionFn,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
)
from amphion_tpu_torch.runtime.optimizers import (
    ClipAdamW,
    MultiSteps,
    clip_by_global_norm_,
    maybe_accumulate,
)
from amphion_tpu_torch.utils.convert import _flax_leaf, from_flax, init_like_flax

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)


T = torch.from_numpy


def _random_tree(module, seed, *args, **kw):
    """A Flax tree of ``module``'s shapes (``jax.eval_shape`` of its
    ``init``: traced, not compiled) with every leaf random, so that parts
    Flax initialises to zero (the adaptive norms' projections) pass
    gradients to everything upstream. Leaves Flax starts at 1 (norm scales,
    the adaptive norms' ``to_weight`` bias) are uniform in [0.5, 1.5] and
    the adaptive norms' kernels small, so each norm stays near the identity;
    other kernels are normal over √fan_in, embeddings normal over
    √features, and the rest (biases) 0.1 normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        adaptive = len(path) > 1 and path[-2].key == "to_weight"
        if name == "scale" or (adaptive and name == "bias"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        std = ((0.2 if adaptive else 1.0) / np.sqrt(np.prod(s.shape[:-1])) if name == "kernel"
               else 1.0 / np.sqrt(s.shape[-1]) if name == "embedding" else 0.1)
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    shapes = jax.eval_shape(functools.partial(module.init, **kw), *args)["params"]
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _grads_by_scope(module, tree) -> dict:
    """Each port parameter's Flax leaf of ``tree`` (a gradient tree), in the
    port's layout, by the port's parameter name."""
    out = {}
    for mname, sub in module.named_modules():
        path = mname.split(".") if mname else []
        for pname, _ in sub.named_parameters(recurse=False):
            out[f"{mname}.{pname}" if mname else pname] = _flax_leaf(sub, tree, path, pname)
    return out


GRAD_ATOL = 1e-4  # the port's gradients against JAX's


def _assert_grads_match(module, jgrads):
    ref = _grads_by_scope(module, jgrads)
    got = {n: p.grad for n, p in module.named_parameters()}
    assert set(got) == set(ref)
    for name, g in got.items():
        assert g is not None, f"{name} got no gradient"
        np.testing.assert_allclose(g.numpy(), ref[name], atol=GRAD_ATOL, rtol=1e-3,
                                   err_msg=name)


# -- kernel 7: the plain backward and the autograd Function ---------------------

BWD_CASES = [  # the JAX test's shapes (tests/test_pallas.py), block sizes too
    (2, 48, 48, 4, 4, 16, False, True, 16, 16),
    (2, 48, 48, 4, 4, 16, True, True, 16, 16),
    (1, 37, 53, 8, 2, 8, True, True, 16, 16),   # GQA + uneven tails
    (2, 64, 64, 4, 2, 32, True, False, 32, 16),
    (1, 50, 30, 2, 1, 16, False, True, 16, 8),  # Lq > Lk
]


def _attn_inputs(seed, b, lq, lk, h, kvh, d, with_mask):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, lk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, lk, kvh, d)).astype(np.float32)
    g = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    mask = None
    if with_mask:
        mask = (rng.random((b, lk)) > 0.2).astype(np.float32)
        mask[:, :4] = 1.0
    return q, k, v, g, mask


@pytest.mark.parametrize("b,lq,lk,h,kvh,d,causal,with_mask,bq,bk", BWD_CASES)
def test_flash_bwd_ref_matches_pallas_interpret(b, lq, lk, h, kvh, d, causal, with_mask,
                                                bq, bk):
    q, k, v, g, mask = _attn_inputs(lq * lk, b, lq, lk, h, kvh, d, with_mask)
    jm = None if mask is None else jnp.asarray(mask)

    @jax.jit  # the interpreted kernels as one program (eagerly they run op by op)
    def pallas_fwd_bwd(q, k, v, g, jm):
        out, lse = flash_attention_pallas(q, k, v, kv_mask=jm, causal=causal, block_q=bq,
                                          block_k=bk, interpret=True, return_lse=True)
        return out, lse, flash_attention_bwd_pallas(q, k, v, jm, out, lse, g, causal=causal,
                                                    block_q=bq, block_k=bk, interpret=True)
    out, lse, ref = pallas_fwd_bwd(q, k, v, g, jm)
    tm = None if mask is None else T(mask)
    # the plain version and the wrapper's CPU branch, from the JAX forward
    args = (T(q), T(k), T(v), tm, T(np.array(out)), T(np.array(lse)), T(g), causal)
    for got in (flash_attention_bwd_ref(*args), flash_attention_bwd(*args)):
        for a, r in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=3e-4, rtol=1e-3)


def test_flash_bwd_ref_bf16_rounds_like_the_kernels():
    """bf16 inputs: P and dS are rounded to bf16 before their products and
    the gradients come back in bf16, close to the float32 ones."""
    q, k, v, g, mask = _attn_inputs(3, 2, 32, 32, 2, 2, 16, True)
    t32 = [T(x) for x in (q, k, v)]
    t16 = [x.bfloat16() for x in t32]
    out, lse = flash_attention(*t16, T(mask), True, return_lse=True)
    g16 = T(g).bfloat16()
    grads = flash_attention_bwd_ref(*t16, T(mask), out, lse, g16, True)
    ref = flash_attention_bwd_ref(*[x.float() for x in t16], T(mask), out.float(), lse,
                                  g16.float(), True)
    for a, r in zip(grads, ref):
        assert a.dtype == torch.bfloat16
        err = (a.float() - r).abs().max().item()
        assert err <= 2e-2 * r.abs().max().item(), err


@pytest.mark.parametrize("causal,with_mask", [(True, True), (False, False)])
def test_flash_function_grads_match_jax_vjp(causal, with_mask):
    """The autograd Function against ``jax.vjp`` of the JAX custom-VJP
    `flash_attention` (Pallas forward and backward, interpreted), GQA."""
    q, k, v, g, mask = _attn_inputs(11, 2, 40, 40, 4, 2, 16, with_mask)
    jm = None if mask is None else jnp.asarray(mask)

    @jax.jit  # one program (eagerly the interpreted kernels run op by op)
    def out_and_vjp(q, k, v, g):
        out, vjp = jax.vjp(lambda a, b_, c: jflash(a, b_, c, jm, causal, 16, 16), q, k, v)
        return out, vjp(g)
    ref_out, refs = out_and_vjp(q, k, v, g)
    leaves = [T(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, None if mask is None else T(mask), causal)
    assert out.grad_fn is not None and out.grad_fn.name() == FlashAttentionFn.__name__ + "Backward"
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=1e-4)
    for a, r in zip(torch.autograd.grad(out, leaves, T(g)), refs):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=3e-4, rtol=1e-3)
    with torch.no_grad():  # no gradient asked: the plain forward, no Function
        assert flash_attention(*leaves, None, causal).grad_fn is None


# -- conditional flow matching ---------------------------------------------------


@pytest.mark.parametrize("mask_kind", [None, "frames"])
def test_cfm_pair_and_loss_match_jax(mask_kind):
    rng = np.random.default_rng(2)
    x1, noise = (rng.standard_normal((3, 10, 6)).astype(np.float32) for _ in range(2))
    t = rng.random(3).astype(np.float32)
    mask = None
    if mask_kind:
        mask = (rng.random((3, 10)) > 0.4).astype(np.float32)
    for got, want in zip(cfm_pair(T(x1), T(t), T(noise), 1e-5),
                         jcfm_pair(jnp.asarray(x1), jnp.asarray(t), jnp.asarray(noise), 1e-5)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    v = rng.standard_normal((3, 10, 6)).astype(np.float32)
    got = cfm_loss(T(v), T(x1), None if mask is None else T(mask)).item()
    want = float(jcfm_loss(jnp.asarray(v), jnp.asarray(x1),
                           None if mask is None else jnp.asarray(mask)))
    assert abs(got - want) <= 1e-6 * abs(want)


# -- the two losses and their gradients -------------------------------------------

FM_KW = dict(token_vocab=64, n_mel=16, hidden=64, num_layers=2, num_heads=4, max_position=128)


@pytest.fixture(scope="module")
def fm_setup():
    rng = np.random.default_rng(7)
    b, n = 3, 24
    mel = rng.standard_normal((b, n, 16)).astype(np.float32)
    tokens = rng.integers(0, 64, (b, n)).astype(np.int32)
    plen = np.array([5, 0, 9])  # row 1 has no prompt: its condition is dropped
    pmask = (np.arange(n)[None] < plen[:, None]).astype(np.float32)
    xmask = np.ones((b, n), np.float32)
    xmask[2, 20:] = 0.0
    key = jax.random.key(5)
    jm = JFM(JFMTConfig(**FM_KW))
    args = [jnp.asarray(x) for x in (mel, tokens, pmask, xmask)]
    params = _random_tree(jm, 1, jax.random.key(0), *args, key, method=JFM.loss)

    def loss_fn(p):
        return jm.apply({"params": p}, *args, key, method=JFM.loss)

    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    r_t, r_n = jax.random.split(key)
    t = np.asarray(jax.random.uniform(r_t, (b,)))
    noise = np.asarray(jax.random.normal(r_n, mel.shape))
    return params, (mel, tokens, pmask, xmask, t, noise), float(loss), jax.device_get(grads)


@pytest.mark.parametrize("remat", [False, True])
def test_fm_loss_and_grads_match_jax(fm_setup, remat):
    params, (mel, tokens, pmask, xmask, t, noise), jloss, jgrads = fm_setup
    model = from_flax(FlowMatchingTransformer(FMTConfig(**FM_KW, remat=remat)), params)
    loss, aux = model.loss(T(mel), T(tokens).long(), T(pmask), T(xmask),
                           t=T(t), noise=T(noise))
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss) and aux["fm_loss"] is loss
    loss.backward()
    _assert_grads_match(model, jgrads)


@pytest.mark.parametrize("setup", ["fm_setup", "ar_setup"])
def test_grads_stand_well_above_the_tolerance(setup, request):
    """Every leaf's JAX gradient in the two loss tests peaks at 10x the
    absolute tolerance the port's gradients are held to or more, so that
    comparison separates a wrong gradient (norm scales near 1 keep the
    projections' gradients at full size)."""
    jgrads = request.getfixturevalue(setup)[-1]
    peaks = {jax.tree_util.keystr(path): float(np.abs(g).max())
             for path, g in jax.tree_util.tree_leaves_with_path(jgrads)}
    low = {name: peak for name, peak in peaks.items() if peak < 10 * GRAD_ATOL}
    assert not low, f"gradients near the {GRAD_ATOL} tolerance: {low}"
    print(f"{setup}: smallest peak |grad| {min(peaks.values()):.3g} "
          f"({min(peaks, key=peaks.get)})")


def test_fm_config_rejects_unknown_time_scheduler():
    with pytest.raises(ValueError, match="time_scheduler"):
        FMTConfig(time_scheduler="sigmoid")
    model = FlowMatchingTransformer(FMTConfig(**FM_KW, time_scheduler="cos"))
    with torch.no_grad():  # draws t and noise from the generator
        loss, _ = model.loss(torch.zeros((2, 8, 16)), torch.zeros((2, 8), dtype=torch.long),
                             torch.zeros((2, 8)), torch.ones((2, 8)),
                             generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)


AR_KW = dict(input_vocab=32, output_vocab=64, hidden=64, intermediate=128, num_layers=2,
             num_heads=4, max_position=256)


@pytest.fixture(scope="module")
def ar_setup():
    rng = np.random.default_rng(9)
    b = 3
    inp = rng.integers(0, 32, (b, 12)).astype(np.int32)
    in_len = np.array([12, 7, 3])
    imask = (np.arange(12)[None] < in_len[:, None]).astype(np.float32)
    out = rng.integers(0, 64, (b, 20)).astype(np.int32)
    out_len = np.array([20, 15, 18])
    omask = (np.arange(20)[None] < out_len[:, None]).astype(np.float32)
    jm = JAR(JARConfig(**AR_KW))
    args = [jnp.asarray(x) for x in (inp, imask, out, omask)]
    params = _random_tree(jm, 2, jax.random.key(0), *args, method=JAR.loss)

    def loss_fn(p):
        return jm.apply({"params": p}, *args, method=JAR.loss)

    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return (params, (inp, imask, out, omask), float(loss), float(aux["ar_acc"]),
            jax.device_get(grads))


@pytest.mark.parametrize("remat", [False, True])
def test_ar_loss_acc_and_grads_match_jax(ar_setup, remat):
    params, (inp, imask, out, omask), jloss, jacc, jgrads = ar_setup
    model = from_flax(ARTransformer(ARTransformerConfig(**AR_KW, remat=remat)), params)
    loss, aux = model.loss(T(inp), T(imask), T(out), T(omask))
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    assert aux["ar_acc"].item() == pytest.approx(jacc, abs=1e-7)
    loss.backward()
    _assert_grads_match(model, jgrads)


def test_ar_forward_rejects_unported_streams(ar_setup):
    _, (inp, imask, out, omask), *_ = ar_setup
    model = ARTransformer(ARTransformerConfig(**AR_KW))
    args = (T(inp), T(imask), T(out), T(omask))
    with pytest.raises(NotImplementedError, match="timbre"):
        model.forward(*args, ref_mel=torch.zeros((3, 8, 80)))
    with pytest.raises(NotImplementedError, match="prosody"):
        model.forward(*args, style_tokens=torch.zeros((3, 4), dtype=torch.long))


# -- optimizer: optax's chain and MultiSteps -------------------------------------


def _optax_run(tx, params, grads_seq):
    """optax's steps, each one jitted program (eager optax runs op by op)."""
    @jax.jit
    def step(g, state, params):
        upd, state = tx.update(g, state, params)
        return optax.apply_updates(params, upd), state

    state = tx.init(params)
    out = []
    for g in grads_seq:
        params, state = step(g, state, params)
        out.append(jax.device_get(params))
    return out


def test_clip_adamw_and_multisteps_match_optax():
    rng = np.random.default_rng(4)
    shapes = {"w": (6, 5), "b": (5,), "s": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    # step norms: above the clip norm, below it, above again
    grads_seq = []
    for scale in (3.0, 0.05, 2.0, 0.3):
        grads_seq.append({k: (scale / 4) * rng.standard_normal(s).astype(np.float32)
                          for k, s in shapes.items()})
    norms = [np.sqrt(sum((g ** 2).sum() for g in gs.values())) for gs in grads_seq]
    assert norms[0] > 1.0 > norms[1] and norms[2] > 1.0
    chain = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-2))
    for k, tx in ((1, chain), (2, optax.MultiSteps(chain, every_k_schedule=2))):
        want = _optax_run(tx, {n: jnp.asarray(p) for n, p in params.items()},
                          grads_seq if k == 2 else grads_seq[:3])
        tparams = [torch.nn.Parameter(T(params[n].copy())) for n in shapes]
        opt = maybe_accumulate(ClipAdamW(tparams, 1e-2), {"gradient_accumulation_steps": k})
        assert isinstance(opt, MultiSteps if k == 2 else ClipAdamW)
        for step, gs in enumerate(grads_seq[:len(want)]):
            opt.apply([T(gs[n].copy()) for n in shapes])
            for n, p in zip(shapes, tparams):
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[step][n]),
                                           atol=1e-6, err_msg=f"k={k} step {step} {n}")


def test_clip_by_global_norm_follows_optax_rule():
    g = [torch.full((4,), 0.5)]  # norm exactly 1.0: optax clips (norm >= max)
    norm = clip_by_global_norm_(g, 1.0)
    assert norm.item() == 1.0
    want = optax.clip_by_global_norm(1.0).update([jnp.full((4,), 0.5)], None)[0][0]
    np.testing.assert_array_equal(g[0].numpy(), np.asarray(want))


# -- Flax initializers ------------------------------------------------------------


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("which", ["fm", "ar", "repcodec"])
def test_init_like_flax_matches_flax_distributions(which):
    """Each parameter drawn with the JAX initializer's distribution: std
    within 10 % of the Flax draw's, zero and one initialisers exact."""
    if which == "fm":
        kw = dict(token_vocab=256, n_mel=80, hidden=128, num_layers=1, num_heads=4)
        jm, port = JFM(JFMTConfig(**kw)), FlowMatchingTransformer(FMTConfig(**kw))
        b, n = 2, 8
        args = (jnp.zeros((b, n, 80)), jnp.zeros((b, n), jnp.int32), jnp.zeros((b, n)),
                jnp.ones((b, n)), jax.random.key(1))
        method = JFM.loss
    elif which == "ar":
        kw = dict(input_vocab=32, output_vocab=256, hidden=128, intermediate=256,
                  num_layers=1, num_heads=4)
        jm, port = JAR(JARConfig(**kw)), ARTransformer(ARTransformerConfig(**kw))
        args = (jnp.zeros((2, 4), jnp.int32), jnp.ones((2, 4)), jnp.zeros((2, 6), jnp.int32),
                jnp.ones((2, 6)))
        method = JAR.loss
    else:
        kw = dict(feature_dim=80, hidden=128, codebook_size=256, codebook_dim=8, num_blocks=2)
        jm, port = JRepCodec(JRepCodecConfig(**kw)), RepCodec(RepCodecConfig(**kw))
        args, method = (jnp.zeros((1, 8, 80)),), JRepCodec.encode
    params = jax.device_get(jax.jit(functools.partial(jm.init, method=method))(
        jax.random.key(3), *args)["params"])
    init_like_flax(port, torch.Generator().manual_seed(3))
    ours = dict(port.named_parameters())
    ref = _grads_by_scope(port, params)  # the Flax leaves, in the port's layout
    assert set(ours) == set(ref)
    for name, p in ours.items():
        got, want = p.detach().numpy(), ref[name]
        if np.all(want == want.flat[0]):  # a constant initialiser: zeros or ones
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert abs(got.std() / want.std() - 1) <= 0.1, (name, got.std(), want.std())
