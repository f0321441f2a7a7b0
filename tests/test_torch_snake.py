"""PyTorch port, kernels 1 and 2 on the CPU: the plain versions of the Snake
kernel (forward and backward) and of the fused anti-aliased SnakeBeta,
and the autograd functions around them, against the JAX package's Pallas
entry points in interpret mode.

Inputs come from a numpy seed. Tolerances: forwards 1e-6 absolute in
float32 (the same arithmetic in the same order; XLA may contract a
multiply-add); bf16 outputs equal or one bf16 step apart; gradients 1e-5
of max|ref| (sums over B and T in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.modules.activations import Snake as JSnake
from amphion_tpu.modules.activations import SnakeBeta as JSnakeBeta
from amphion_tpu.modules.anti_aliasing import downsample1d as jdown
from amphion_tpu.modules.anti_aliasing import kaiser_sinc_filter1d as jkaiser
from amphion_tpu.modules.anti_aliasing import upsample1d as jup
from amphion_tpu.ops import pallas_kernels as pk
from amphion_tpu_torch.modules.activations import Snake, SnakeBeta
from amphion_tpu_torch.modules.anti_aliasing import (
    downsample1d,
    kaiser_sinc_filter1d,
    upsample1d,
)
from amphion_tpu_torch.ops.kernels.aa_snake import (
    AASnakeBetaFn,
    aa_polyphase_taps,
    aa_snake,
    aa_snakebeta,
    aa_snakebeta_ref,
)
from amphion_tpu_torch.ops.kernels.snake import SnakeFn, snake, snake_bwd, snake_bwd_ref, snake_ref

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)


T = torch.from_numpy


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    a = rng.uniform(0.5, 2.0, shape[-1]).astype(np.float32)
    b = rng.uniform(0.5, 2.0, shape[-1]).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, a, b, g


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


def _jax_vjp(fn, g, *args):
    """JAX's output of ``fn`` at ``args`` and its gradients against
    cotangent ``g``, in one jitted call (an eager VJP of an interpreted
    Pallas kernel takes seconds)."""
    def vjp(g, *args):
        y, pull = jax.vjp(fn, *args)
        return y, pull(g)

    return jax.jit(vjp)(jnp.asarray(g), *(jnp.asarray(a) for a in args))


def _within_one_bf16_step(out: torch.Tensor, ref: np.ndarray) -> bool:
    """``out`` (bf16) equals ``ref`` rounded to bf16, or is one bf16 step
    (8 significant bits) away from it."""
    o = out.float().numpy()
    r = T(np.array(ref, np.float32)).bfloat16().float().numpy()
    big = np.maximum(np.abs(o), np.abs(r))
    step = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    return bool(np.all(np.abs(o - r) <= step))


# -- kernel 1: Snake ---------------------------------------------------------

def test_snake_ref_matches_pallas():
    """The plain forward against the Pallas kernel (interpret mode, one
    jitted call) and both against the formula in float64, so that a
    failure names the side that moved."""
    x, a, _, _ = _inputs(0, (2, 300, 8))  # T not a multiple of the 256-row tile
    x64, a64 = x.astype(np.float64), a.astype(np.float64)
    exact = x64 + np.sin(a64 * x64) ** 2 / (a64 + 1e-9)
    ref = np.asarray(jax.jit(lambda x, a: pk.snake_pallas(x, a, True))(x, a))
    out = snake_ref(T(x), T(a)).numpy()
    np.testing.assert_allclose(out, exact, rtol=0, atol=1e-6, err_msg="snake_ref")
    np.testing.assert_allclose(ref, exact, rtol=0, atol=1e-6, err_msg="snake_pallas")
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(snake(T(x), T(a)).numpy(), out)


def test_snake_bwd_ref_matches_pallas_vjp():
    x, a, _, g = _inputs(2, (2, 300, 8))
    _, (jdx, jda) = _jax_vjp(lambda x, a: pk.snake_pallas(x, a, True), g, x, a)
    dx, da = snake_bwd_ref(T(x), T(a), T(g))
    assert _rel(dx, jdx) <= 1e-5 and _rel(da, jda) <= 1e-5
    dx2, da2 = snake_bwd(T(x), T(a), T(g))
    assert torch.equal(dx, dx2) and torch.equal(da, da2)


@pytest.mark.parametrize("logscale", [False, True])
def test_snake_module_kernel_path_grads_match_jax(logscale):
    """`Snake(use_pallas=True)` (through `SnakeFn`) against what the JAX
    module computes with ``use_pallas`` (`snake_pallas` and its custom VJP
    on ``exp(alpha)`` under logscale): output and gradients."""
    x, a, _, g = _inputs(3, (2, 300, 8))
    p = np.log(a) if logscale else a

    def jf(p, x):
        alpha = jnp.exp(p) if logscale else p
        return pk.snake_pallas(x, alpha, True)

    jy, (jgp, jgx) = _jax_vjp(jf, g, p, x)
    m = Snake(8, alpha_logscale=logscale, use_pallas=True)
    with torch.no_grad():
        m.alpha.copy_(T(p))
    xt = T(x).requires_grad_()
    y = m(xt)
    y.backward(T(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    assert _rel(xt.grad, jgx) <= 1e-5
    assert _rel(m.alpha.grad, jgp) <= 1e-5


@pytest.mark.parametrize("cls", ["Snake", "SnakeBeta"])
def test_plain_activations_match_jax(cls):
    x, a, b, _ = _inputs(4, (2, 50, 6))
    if cls == "Snake":
        jm, m, params = JSnake(6), Snake(6), {"alpha": a}
    else:
        jm, m = JSnakeBeta(6), SnakeBeta(6)
        params = {"alpha": np.log(a), "beta": np.log(b)}
    ref = np.asarray(jm.apply({"params": {k: jnp.asarray(v) for k, v in params.items()}},
                              jnp.asarray(x)))
    with torch.no_grad():
        for k, v in params.items():
            getattr(m, k).copy_(T(v))
        out = m(T(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_snake_function_gradcheck_against_formula():
    """`SnakeFn`'s backward is JAX's formula, which equals autograd of the
    forward up to the 1e-9 terms."""
    x, a, _, g = _inputs(5, (1, 20, 4))
    xt, at = T(x).requires_grad_(), T(a).requires_grad_()
    (SnakeFn.apply(xt, at) * T(g)).sum().backward()
    x2, a2 = T(x).requires_grad_(), T(a).requires_grad_()
    (snake_ref(x2, a2) * T(g)).sum().backward()
    assert _rel(xt.grad, x2.grad) <= 1e-5 and _rel(at.grad, a2.grad) <= 1e-4


# -- kernel 2: anti-aliased SnakeBeta -------------------------------------------

def test_aa_polyphase_taps_equal_jax_probe():
    assert aa_polyphase_taps() == pk._aa_polyphase_taps()


@pytest.mark.parametrize("cutoff,half_width,k", [(0.25, 0.3, 12), (0.5 / 3, 0.2, 18), (0.2, 0.1, 7)])
def test_kaiser_sinc_filter_equals_jax(cutoff, half_width, k):
    np.testing.assert_array_equal(kaiser_sinc_filter1d(cutoff, half_width, k),
                                  jkaiser(cutoff, half_width, k))


@pytest.mark.parametrize("which", ["up", "down"])
def test_resamplers_match_jax(which):
    x, _, _, _ = _inputs(6, (2, 40, 3))
    jf, tf = (jup, upsample1d) if which == "up" else (jdown, downsample1d)
    ref = np.asarray(jf(jnp.asarray(x), 2))
    out = tf(T(x), 2).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_aa_snakebeta_ref_matches_pallas_f32():
    # (2, 600, 8): two JAX tiles of 512 and a ragged tail; whole signal, edges included
    x, a, b, _ = _inputs(7, (2, 600, 8))
    ref = np.asarray(pk.aa_snakebeta_pallas(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                            True))
    out = aa_snakebeta_ref(T(x), T(a), T(b))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    assert torch.equal(aa_snakebeta(T(x), T(a), T(b)), out)


def test_aa_snakebeta_ref_matches_pallas_bf16():
    x, a, b, _ = _inputs(8, (2, 600, 8))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(pk.aa_snakebeta_pallas(xb, jnp.asarray(a), jnp.asarray(b), True)
                     .astype(jnp.float32))
    out = aa_snakebeta_ref(T(x).bfloat16(), T(a), T(b))
    assert out.dtype == torch.bfloat16
    assert _within_one_bf16_step(out, ref)


def test_aa_snakebeta_short_signal_matches_pallas():
    x, a, b, _ = _inputs(9, (1, 5, 4))  # T < the 13-sample window
    ref = np.asarray(pk.aa_snakebeta_pallas(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                            True))
    np.testing.assert_allclose(aa_snakebeta_ref(T(x), T(a), T(b)).numpy(), ref, rtol=0,
                               atol=1e-6)


def test_aa_snakebeta_function_grads_match_jax_vjp():
    x, a, b, g = _inputs(10, (2, 96, 4))
    _, refs = _jax_vjp(lambda x, a, b: pk.aa_snakebeta_pallas(x, a, b, True), g, x, a, b)
    leaves = [T(v).requires_grad_() for v in (x, a, b)]
    y = AASnakeBetaFn.apply(*leaves)
    np.testing.assert_allclose(y.detach().numpy(), aa_snakebeta_ref(*(T(v) for v in (x, a, b))),
                               rtol=0, atol=0)
    y.backward(T(g))
    for leaf, ref in zip(leaves, refs):
        assert _rel(leaf.grad, ref) <= 1e-5


def test_aa_snake_alpha_grad_sums_both_uses():
    x, a, _, g = _inputs(11, (1, 80, 4))
    _, (jdx, jda) = _jax_vjp(lambda x, a: pk.aa_snake_pallas(x, a, True), g, x, a)
    xt, at = T(x).requires_grad_(), T(a).requires_grad_()
    aa_snake(xt, at).backward(T(g))
    assert _rel(xt.grad, jdx) <= 1e-5 and _rel(at.grad, jda) <= 1e-5


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, a, b, _ = _inputs(12, (1, 16, 4))
    with pytest.raises(ValueError):
        aa_snakebeta(T(x)[0], T(a), T(b))  # 2-D
    with pytest.raises(ValueError):
        aa_snakebeta(T(x).double(), T(a), T(b))
    with pytest.raises(ValueError):
        aa_snakebeta(T(x).transpose(1, 2).contiguous().transpose(1, 2), T(a), T(b))
    with pytest.raises(ValueError):
        aa_snakebeta(T(x), T(a)[:3], T(b))
    with pytest.raises(ValueError):
        snake(T(x), T(a).double())
    with pytest.raises(ValueError):
        snake_bwd(T(x), T(a), T(x)[:, :8])
