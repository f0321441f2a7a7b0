"""PyTorch port, VITS on the CPU against the JAX package: the windowed
relative attention, the flows and the spline, the stochastic duration
predictor, the length regulator, monotonic alignment search, the model's
training and inference paths, one whole D-then-G training step, and the
CLIs (preprocess → train → inference) on a tiny LJSpeech corpus.

The same numpy inputs and, through `utils/convert.from_flax`, the same
weights (random leaves in the Flax init's shapes, from ``jax.eval_shape``)
go to both; JAX's `jax.random` draws are computed from the same keys JAX
splits and handed to the port. Tolerances (float32): 1e-4 absolute, or 1e-4
of max|ref| where that exceeds 1; the alignment path, `maximum_path` and
the sampled durations exactly; the training step's parameter updates
within 1 % of lr on at least 1 − 1e-3 of the elements (Adam's first update
is about lr·sign(g)). JAX compiles with most XLA optimizations off
(`quick_xla`). Tiny sizes: width ≤ 32, two encoder layers, a HiFi-GAN of
rates (2, 2).
"""

import contextlib
import copy
import functools
import json
import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.models.tts.vits import vits_trainer as jvt
from amphion_tpu.models.tts.vits.vits import VITS as JVITS
from amphion_tpu.models.tts.vits.vits import VITSConfig as JVITSConfig
from amphion_tpu.models.vocoders.gan_trainer import CombinedDiscriminator as JCombined
from amphion_tpu.models.vocoders.gan_trainer import GANTrainConfig as JGANTrainConfig
from amphion_tpu.models.vocoders.gan_trainer import make_optimizer as j_make_optimizer
from amphion_tpu.models.vocoders.hifigan import HiFiGANConfig as JHiFiGANConfig
from amphion_tpu.modules import duration as jdur
from amphion_tpu.modules import flows as jflows
from amphion_tpu.modules import transformer as jtr
from amphion_tpu.ops.mas import maximum_path as j_maximum_path
from amphion_tpu.ops.mel import MelConfig as JMelConfig
from amphion_tpu.ops.mel import linear_spectrogram as j_linear_spectrogram
from amphion_tpu.runtime.train_state import TrainState as JTrainState
from amphion_tpu_torch.bins.tts import inference as port_infer
from amphion_tpu_torch.bins.tts import preprocess as port_pre
from amphion_tpu_torch.bins.tts import train as port_train
from amphion_tpu_torch.data.audio_io import load_wav, save_wav
from amphion_tpu_torch.models.tts.vits.vits import VITS, VITSConfig
from amphion_tpu_torch.models.tts.vits.vits_trainer import (
    create_vits_states,
    make_vits_train_step,
)
from amphion_tpu_torch.models.vocoders.gan_trainer import CombinedDiscriminator, GANTrainConfig
from amphion_tpu_torch.models.vocoders.hifigan import HiFiGANConfig
from amphion_tpu_torch.modules import duration, flows, transformer
from amphion_tpu_torch.ops.mas import maximum_path
from amphion_tpu_torch.ops.mel import MelConfig, linear_spectrogram
from amphion_tpu_torch.utils.convert import from_flax
from test_torch_tts_losses import quick_xla

torch.set_num_threads(1)  # one xdist worker per core

T = torch.from_numpy
MEL = dict(sample_rate=8000, n_fft=32, win_size=16, hop_size=4, n_mel=8, fmin=0, fmax=4000)
DEC = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4), upsample_initial_channel=16,
           resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),), n_mel=16)
MODEL = dict(num_phones=40, spec_channels=17, inter_channels=16, hidden_channels=32,
             filter_channels=64, n_heads=2, n_layers=2, n_speakers=3, gin_channels=8,
             segment_size=8)
DISC = dict(use=("mpd", "msd"), mpd_periods=(2,), msd_scales=1, channel_mult=0.0625)
B, L, FRAMES = 2, 7, 24
LR = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _quick_xla():
    with quick_xla(), quick_trace():
        yield


@contextlib.contextmanager
def quick_trace():
    """Trace JAX's programs without the Python traceback of each operation
    (location metadata only; about a sixth of a VITS step's trace time),
    restoring the settings after."""
    keys = ("jax_include_full_tracebacks_in_locations", "jax_traceback_in_locations_limit")
    old = [getattr(jax.config, k) for k in keys]
    jax.config.update(keys[0], False)
    jax.config.update(keys[1], 0)
    try:
        yield
    finally:
        for k, v in zip(keys, old):
            jax.config.update(k, v)


def fill(shapes, seed: int):
    """Random leaves for a Flax tree of shapes: kernels normal over √fan_in,
    weight-norm scales in [0.3, 0.8], LayerNorm scales near 1, embeddings
    over √features, the rest (biases, relative embeddings, affine flows)
    0.1 normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name.endswith("/scale"):
            return rng.uniform(0.3, 0.8, s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        std = (1.0 / np.sqrt(np.prod(s.shape[:-1])) if name == "kernel"
               else 1.0 / np.sqrt(s.shape[-1]) if name == "embedding" else 0.1)
        return (std * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(leaf, shapes))


def random_tree(module, seed, *args, method=None, **kw):
    init = functools.partial(flax.linen.Module.init, module, method=method, **kw)
    return fill(jax.eval_shape(init, jax.random.key(0), *args)["params"], seed)


@functools.cache
def jit_apply(module, method=None):
    """``module.apply`` jitted, its parameters the first argument."""
    return jax.jit(lambda params, *args, **kw: module.apply({"params": params}, *args,
                                                            method=method, **kw),
                   static_argnames=("reverse",))


def close(out, ref, tol: float = 1e-4, what: str = ""):
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()),
                               err_msg=what)


def masks(rng, b: int, n: int, lengths=None):
    lengths = rng.integers(n // 2, n + 1, b) if lengths is None else np.asarray(lengths)
    return (np.arange(n)[None] < lengths[:, None]).astype(np.float32)


# -- modules ----------------------------------------------------------------------------


def test_relative_attention_with_key_mask_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 9, 32)).astype(np.float32)
    mask = masks(rng, 3, 9, [9, 4, 6])
    jm = jtr.MultiHeadAttention(32, 2, window_size=4)
    bias = jtr.attention_bias_from_mask(jnp.asarray(mask))
    tree = random_tree(jm, 2, x, bias=bias)
    ref = jit_apply(jm)(tree, x, bias=bias)
    port = from_flax(transformer.MultiHeadAttention(32, 2, window_size=4), tree)
    out = port(T(x), bias=transformer.attention_bias_from_mask(T(mask)))
    close(out, ref, what="attention")
    # the encoder stack around it (two layers, the FFN's masked convolutions)
    je = jtr.TransformerEncoder(32, 2, 2, 64, 3, window_size=4)
    tree = random_tree(je, 3, x, mask)
    port = from_flax(transformer.TransformerEncoder(32, 2, 2, 64, 3, window_size=4), tree)
    close(port(T(x), T(mask)), jit_apply(je)(tree, x, mask), what="encoder")


def flow_cases():
    return {
        "coupling_block": (jflows.ResidualCouplingBlock(4, 16, 5, 1, 2, n_flows=2,
                                                        gin_channels=8),
                           flows.ResidualCouplingBlock(4, 16, 5, 1, 2, n_flows=2,
                                                       gin_channels=8), 4, True),
        "conv_flow": (jflows.ConvFlow(2, 16, 3, 3), flows.ConvFlow(2, 16, 3, 3), 2, True),
        "affine": (jflows.ElementwiseAffine(2), flows.ElementwiseAffine(2), 2, False),
    }


@pytest.mark.parametrize("name", ["coupling_block", "conv_flow", "affine", "log"])
def test_flow_forward_and_inverse_match_jax(name):
    """Forward (y, logdet) against JAX; JAX's inverse of y against the
    port's; and the port's own round trip back to x on the kept frames."""
    rng = np.random.default_rng(4)
    mask = masks(rng, B, 10, [10, 6])
    if name == "log":
        x = rng.uniform(0.05, 3.0, (B, 10, 1)).astype(np.float32)
        y, ld = jflows.log_flow(jnp.asarray(x), jnp.asarray(mask))
        py, pld = flows.log_flow(T(x), T(mask))
        close(py, y, what="y")
        close(pld, ld, what="logdet")
        close(flows.log_flow(py, T(mask), reverse=True), jflows.log_flow(
            y, jnp.asarray(mask), reverse=True), what="inverse")
        return
    jm, port, c, takes_g = flow_cases()[name]
    x = (2.0 * rng.standard_normal((B, 10, c))).astype(np.float32)
    kw = {"g": rng.standard_normal((B, 1, 8) if c == 4 else (B, 10, 16)).astype(np.float32)
          } if takes_g else {}
    tree = random_tree(jm, 5, x, mask, **kw)
    port = from_flax(port, tree)
    y, ld = jit_apply(jm)(tree, x, mask, **kw)
    py, pld = port(T(x), T(mask), **{k: T(v) for k, v in kw.items()})
    close(py, y, what="y")
    close(pld, ld, what="logdet")
    back = port(py, T(mask), reverse=True, **{k: T(v) for k, v in kw.items()})
    close(back, jit_apply(jm)(tree, y, mask, reverse=True, **kw), what="inverse")
    close(back * T(mask)[..., None], x * mask[..., None], 1e-4, "round trip")


def test_spline_at_bin_edges_and_outside_its_tails_matches_jax():
    """Values on the knots (JAX's own), between them, at ±tail_bound and
    beyond it (the identity tails), forward and inverse."""
    rng = np.random.default_rng(6)
    n, k = 40, 10
    widths, heights = (rng.standard_normal((n, k)).astype(np.float32) for _ in range(2))
    derivs = rng.standard_normal((n, k - 1)).astype(np.float32)
    w = np.asarray(jax.nn.softmax(jnp.asarray(widths), axis=-1))
    w = 1e-3 + (1 - 1e-3 * k) * w
    knots = np.concatenate([np.zeros((n, 1)), np.cumsum(w, -1)], -1) * 10.0 - 5.0
    x = np.stack([knots[np.arange(n), rng.integers(0, k + 1, n)],  # on a knot
                  rng.uniform(-5, 5, n), np.full(n, 5.0), np.full(n, -5.0),
                  rng.uniform(5.01, 9, n), -rng.uniform(5.01, 9, n)], 1).astype(np.float32)
    args = [np.broadcast_to(a[:, None], (n, 6) + a.shape[1:]).copy()
            for a in (widths, heights, derivs)]
    for inverse in (False, True):
        fn = jax.jit(functools.partial(jflows.rational_quadratic_spline, inverse=inverse))
        y, ld = fn(x, *args)
        py, pld = flows.rational_quadratic_spline(T(x), *map(T, args), inverse=inverse)
        close(py, y, what=f"y inverse={inverse}")
        close(pld, ld, what=f"logdet inverse={inverse}")
        outside = np.abs(x) > 5.0
        assert np.array_equal(py.numpy()[outside], x[outside])


def test_sdp_both_directions_match_jax_with_its_noises():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, L, 32)).astype(np.float32)
    mask = masks(rng, B, L, [7, 4])
    w = (rng.integers(1, 5, (B, L)) * mask).astype(np.float32)
    g = rng.standard_normal((B, 1, 8)).astype(np.float32)
    jm = jdur.StochasticDurationPredictor(32, 3, 0.5, 4, gin_channels=8)
    key = jax.random.key(3)
    tree = random_tree(jm, 8, x, mask, w=w, g=g, rng=key)
    port = from_flax(duration.StochasticDurationPredictor(32, 3, 4, gin_channels=8), tree)
    nll = jit_apply(jm)(tree, x, mask, w=w, g=g, rng=key)
    e_q = np.asarray(jax.random.normal(key, (B, L, 2)))
    close(port(T(x), T(mask), w=T(w), g=T(g), e_q=T(e_q)), nll, what="nll")
    logw = jit_apply(jm)(tree, x, mask, g=g, reverse=True, noise_scale=0.8, rng=key)
    out = port(T(x), T(mask), g=T(g), reverse=True, noise_scale=0.8, noise=T(e_q))
    close(out, logw, what="reverse")


def test_length_regulate_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 6, 5)).astype(np.float32)
    durs = rng.integers(0, 5, (3, 6)).astype(np.int32)
    durs[2] = [9, 9, 9, 9, 0, 9]  # longer than max_len: cut
    ref, ref_mask = jdur.length_regulate(jnp.asarray(x), jnp.asarray(durs), 24)
    out, mask = duration.length_regulate(T(x), T(durs), 24)
    close(out, ref)
    assert np.array_equal(mask.numpy(), np.asarray(ref_mask))


# -- monotonic alignment ------------------------------------------------------------------


def lattices():
    rng = np.random.default_rng(10)
    b, tt, tm = 4, 9, 30
    value = rng.standard_normal((b, tt, tm)).astype(np.float32)
    mask = masks(rng, b, tt, [9, 5, 7, 1])[:, :, None] * masks(rng, b, tm, [30, 17, 12, 6])[
        :, None, :]
    # ties everywhere: small integers, and one all-zero row
    ties = rng.integers(-2, 3, (b, tt, tm)).astype(np.float32)
    ties[1] = 0.0
    return {"random": (value, mask), "ties": (ties, mask),
            "full": (value, np.ones_like(value))}


@pytest.mark.parametrize("case", ["random", "ties", "full"])
def test_maximum_path_is_exact(case):
    value, mask = lattices()[case]
    ref = np.asarray(j_maximum_path(jnp.asarray(value), jnp.asarray(mask)))
    out = maximum_path(T(value), T(mask)).numpy()
    assert np.array_equal(out, ref)
    # monotonic, one token a frame on the kept frames, ends at (text_len − 1, mel_len − 1)
    assert np.array_equal(out.sum(1), mask[:, 0, :])


# -- the model ----------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def tiny_vits():
    """(JAX model, Flax tree, port model, batch) of the tiny speaker model:
    phones with padding, ragged frames, the batch's linear spectrogram."""
    jcfg = JVITSConfig(**MODEL, decoder=JHiFiGANConfig(**DEC))
    jm = JVITS(jcfg)
    rng = np.random.default_rng(11)
    pm = masks(rng, B, L, [7, 5])
    phones = (rng.integers(1, 40, (B, L)) * pm).astype(np.int32)
    t = FRAMES * 4
    n = np.arange(t)
    audio = (0.4 * np.sin(n[None] * rng.uniform(0.1, 0.5, (B, 1)))
             + 0.05 * rng.standard_normal((B, t))).astype(np.float32)
    frames = np.array([FRAMES, 17])
    audio[1, 17 * 4:] = 0.0
    spec = np.asarray(j_linear_spectrogram(jnp.asarray(audio), JMelConfig(**MEL))).transpose(
        0, 2, 1)
    sm = masks(rng, B, FRAMES, frames)
    batch = {"phones": phones, "phone_mask": pm, "spec": spec, "spec_mask": sm,
             "audio": audio, "sid": np.array([2, 0], np.int32)}
    tree = random_tree(jm, 12, phones, pm, spec, sm, jax.random.key(1), batch["sid"],
                       method=JVITS.train_forward)
    cfg = VITSConfig(**MODEL, decoder=HiFiGANConfig(**DEC))
    return jm, tree, from_flax(VITS(cfg), tree), batch


def torch_batch(batch):
    out = {k: T(v) for k, v in batch.items()}
    return {**out, "phones": out["phones"].long(), "sid": out["sid"].long()}


@jax.jit
def train_draws(key, spec_mask):
    """JAX `VITS.train_forward`'s draws from ``key`` (the split it makes)."""
    rng_post, rng_dur, rng_seg = jax.random.split(key, 3)
    b, t = spec_mask.shape
    noise = jax.random.normal(rng_post, (b, t, MODEL["inter_channels"]))
    e_q = jax.random.normal(rng_dur, (b, L, 2))
    max_start = jnp.maximum(jnp.sum(spec_mask, -1).astype(jnp.int32) - MODEL["segment_size"],
                            0)
    start = (jax.random.uniform(rng_seg, (b,)) * (max_start + 1).astype(jnp.float32)).astype(
        jnp.int32)
    return noise, e_q, start


def test_linear_spectrogram_matches_jax():
    _, _, _, batch = tiny_vits()
    port = linear_spectrogram(T(batch["audio"]), MelConfig(**MEL)).transpose(1, 2)
    close(port, batch["spec"])


def test_train_forward_matches_jax_with_its_draws():
    jm, tree, model, batch = tiny_vits()
    key = jax.random.key(5)
    ref = jit_apply(jm, JVITS.train_forward)(
        tree, batch["phones"], batch["phone_mask"], batch["spec"], batch["spec_mask"], key,
        batch["sid"])
    noise, e_q, start = map(np.asarray, train_draws(key, batch["spec_mask"]))
    tb = torch_batch(batch)
    with torch.no_grad():
        out = model.train_forward(tb["phones"], tb["phone_mask"], tb["spec"], tb["spec_mask"],
                                  tb["sid"], noise=T(noise), e_q=T(e_q),
                                  segment_start=T(start.astype(np.int64)))
    assert np.array_equal(out["attn"].numpy(), np.asarray(ref["attn"]))
    assert np.array_equal(out["segment_start"].numpy(), np.asarray(ref["segment_start"]))
    for k in ("z_p", "m_p", "logs_p", "m_q", "logs_q", "l_length", "wav_segment"):
        close(out[k], ref[k], what=k)


def test_infer_matches_jax_with_its_noises():
    jm, tree, model, batch = tiny_vits()
    key = jax.random.key(8)
    max_frames = 40
    wav, fmask, durs = jax.jit(lambda p, ph, pm, k, sid: jm.apply(
        {"params": p}, ph, pm, k, sid, 0.667, 1.0, 0.8, max_frames, method=JVITS.infer))(
        tree, batch["phones"], batch["phone_mask"], key, batch["sid"])
    rng_dur, rng_z = jax.random.split(key)
    dur_noise = np.asarray(jax.random.normal(rng_dur, (B, L, 2)))
    z_noise = np.asarray(jax.random.normal(rng_z, (B, max_frames, MODEL["inter_channels"])))
    tb = torch_batch(batch)
    with torch.no_grad():
        pw, pmask, pdurs = model.infer(tb["phones"], tb["phone_mask"], tb["sid"], 0.667, 1.0,
                                       0.8, max_frames, dur_noise=T(dur_noise),
                                       z_noise=T(z_noise))
    assert np.array_equal(pdurs.numpy(), np.asarray(durs))
    assert np.array_equal(pmask.numpy(), np.asarray(fmask))
    close(pw, wav, what="waveform")


def test_voice_conversion_to_the_same_speaker_decodes_the_posterior_mean():
    """Source and target speaker equal, no noise: the flow's reverse undoes
    its forward, so the conversion is the decoder of the masked posterior
    mean (a composition of the parts held to JAX above)."""
    _, _, model, batch = tiny_vits()
    tb = torch_batch(batch)
    with torch.no_grad():
        out = model.voice_conversion(tb["spec"], tb["spec_mask"], tb["sid"], tb["sid"])
        g = model._speaker(tb["sid"])
        z, _, _ = model.posterior(tb["spec"], tb["spec_mask"], g=g)
        want = model.decoder(z * tb["spec_mask"][..., None], g=g)
        other = model.voice_conversion(tb["spec"], tb["spec_mask"], tb["sid"],
                                       tb["sid"].flip(0))
    close(out, want.numpy(), 1e-4, "same speaker")
    assert out.shape == (B, FRAMES * 4) and not torch.allclose(out, other)


def assert_updates_agree(port, ref, start, lr: float = LR):
    """Δport against Δref (both from ``start``): within 1 % of lr on at
    least 1 − 1e-3 of all elements."""
    total = off = 0
    for p, r, s in zip(port.parameters(), ref.parameters(), start.parameters()):
        d = ((p - s) - (r - s)).abs().detach()
        total += d.numel()
        off += int((d > 0.01 * lr).sum())
    assert total and off <= 1e-3 * total, f"{off} of {total} updates differ by > 1 % of lr"
    moved = max((p - s).abs().max().item() for p, s in zip(port.parameters(),
                                                           start.parameters()))
    assert 0.5 * lr < moved < 3 * lr


def test_train_step_matches_jax():
    """One whole `make_vits_train_step` against JAX's jitted one from the
    same weights and batch, with JAX's draws: every metric within 1e-4 of
    max(1, |ref|), the G and D updates agreeing."""
    jm, tree, _, batch = tiny_vits()
    jd = JCombined(**DISC)
    seg_audio = batch["audio"][:, : MODEL["segment_size"] * 4]
    d_tree = fill(jax.eval_shape(jd.init, jax.random.key(0), seg_audio)["params"], 13)
    jcfg = JGANTrainConfig()
    tx = j_make_optimizer(jcfg)

    def state(module, t):
        t = jax.tree_util.tree_map(jnp.array, t)  # copies: the step donates them
        return JTrainState(step=jnp.zeros((), jnp.int32), params=t,
                           opt_state=jax.jit(tx.init)(t), rng=jax.random.key(21),
                           apply_fn=module.apply, tx=tx)

    jstep = jvt.make_vits_train_step(jm, JMelConfig(**MEL), jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgs, jds, jmet = jstep(state(jm, tree), state(jd, d_tree), jbatch)
    _, step_key = jax.random.split(jax.random.key(21))
    noise, e_q, start = map(np.asarray, train_draws(step_key, batch["spec_mask"]))

    model = from_flax(VITS(VITSConfig(**MODEL, decoder=HiFiGANConfig(**DEC))), tree)
    disc = from_flax(CombinedDiscriminator(**DISC), d_tree)
    start_g, start_d = copy.deepcopy(model), copy.deepcopy(disc)
    gs, ds = create_vits_states(model, disc, GANTrainConfig())
    gs, ds, met = make_vits_train_step(MelConfig(**MEL), GANTrainConfig())(
        gs, ds, torch_batch(batch), {"noise": T(noise), "e_q": T(e_q),
                                     "segment_start": T(start.astype(np.int64))})
    for k in ("d_loss", "g_loss", "g_adv", "g_fm", "g_mel", "g_kl", "g_dur"):
        close(met[k], jmet[k], what=k)
    ref_g = from_flax(copy.deepcopy(model), jax.tree_util.tree_map(np.asarray, jgs.params))
    ref_d = from_flax(copy.deepcopy(disc), jax.tree_util.tree_map(np.asarray, jds.params))
    assert_updates_agree(model, ref_g, start_g)
    assert_updates_agree(disc, ref_d, start_d)


# -- the CLIs -------------------------------------------------------------------------------


SR = 8000
TEXTS = ["hello world", "good morning to you", "a tiny corpus", "the quick brown fox",
         "jumps over the lazy dog", "synthetic speech again"]
PREPROCESS = {"sample_rate": SR, "n_mel": 8, "n_fft": 32, "win_size": 16, "hop_size": 4,
              "fmin": 0, "fmax": 4000, "f0_min": 50, "f0_max": 1100}


def write_ljspeech(root, n: int = 6, seed: int = 0) -> None:
    """``n`` clips in LJSpeech's layout (``metadata.csv`` of
    ``id|raw|normalized``, ``wavs/<id>.wav``), 180-260 samples."""
    rng = np.random.default_rng(seed)
    (root / "wavs").mkdir(parents=True, exist_ok=True)
    rows = []
    for i in range(n):
        uid = f"LJ001-{i:04d}"
        t = np.arange(int(rng.integers(180, 260))) / SR
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(120, 260) * t) + 0.02 * rng.standard_normal(
            t.shape)
        save_wav(root / "wavs" / f"{uid}.wav", x.astype(np.float32), SR)
        rows.append(f"{uid}|{TEXTS[i % len(TEXTS)].upper()}|{TEXTS[i % len(TEXTS)]}")
    (root / "metadata.csv").write_text("\n".join(rows) + "\n")


def cli_config(root, model_type: str, base: str, model: dict, **train) -> str:
    cfg = {"base_config": base, "model_type": model_type, "dataset": ["ljspeech"],
           "dataset_path": {"ljspeech": str(root / "raw")}, "log_dir": str(root / "ckpts"),
           "preprocess": {**PREPROCESS, "processed_dir": str(root / "processed"),
                          "extract_phone": True},
           "model": model, "train": {"batch_size": 2, "max_steps": 1, "log_interval": 1,
                                     "seed": 0, **train}}
    path = root / f"{model_type}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


TINY = {"vits": {"inter_channels": 16, "hidden_channels": 32, "filter_channels": 64,
                 "n_heads": 2, "n_layers": 2},
        "decoder": {"resblock": "1", "upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
                    "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
                    "resblock_dilation_sizes": [[1]]},
        "discriminators": ["mpd", "msd"], "discriminator_channel_mult_factor": 0.0625,
        "mpd_periods": [2], "msd_scales": 1}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The tiny LJSpeech corpus through `bins/tts/preprocess.py` (the
    adapter, phones and ``symbols.dict``) → (root, config path)."""
    from pathlib import Path

    root = tmp_path_factory.mktemp("vits_cli")
    write_ljspeech(root / "raw")
    repo = Path(__file__).resolve().parents[1]
    cfg = cli_config(root, "VITS", str(repo / "config/vits.json"), TINY, segment_size=8,
                     max_frames=50, max_phones=21)
    port_pre.main(["--config", cfg, "--device", "cpu"])
    assert (root / "processed" / "ljspeech" / "symbols.dict").is_file()
    return root, cfg


def test_cli_preprocess_train_infer(corpus):
    """``--device cpu``: one training step through `bins/tts/train.py` (a
    checkpoint and ``spk2id.json``), then `bins/tts/inference.py` from it: a
    finite wav of whole frames, no longer than ``--max_frames``."""
    root, cfg = corpus
    trainer = port_train.main(["--config", cfg, "--exp_name", "vits", "--device", "cpu"])
    assert trainer.loop.step == 1
    assert json.loads((root / "ckpts" / "vits" / "spk2id.json").read_text()) == {
        "LJSpeech": 0}
    out = root / "out.wav"
    port_infer.main(["--config", cfg, "--exp_name", "vits", "--text", "hello fox",
                     "--output_path", str(out), "--max_frames", "50", "--device", "cpu"])
    wav, sr = load_wav(out)
    assert sr == SR and 0 < len(wav) <= 50 * 4 and len(wav) % 4 == 0
    assert np.isfinite(wav).all()


def test_trainer_batches_follow_jax(corpus):
    """`VITSTrainer`'s first batch of epoch 0: JAX's utterances, phones
    (blanks interspersed, cut to ``max_phones``), masks, audio and speaker
    ids, and its linear spectrogram within 1e-4."""
    from amphion_tpu.runtime.tts_trainer import VITSTrainer as JVITSTrainer
    from amphion_tpu.utils.config import JsonHParams
    from amphion_tpu_torch.runtime.tts_trainer import VITSTrainer
    from amphion_tpu_torch.utils.config import load_config

    root, cfg_path = corpus
    cfg = load_config(cfg_path)
    trainer = VITSTrainer(types.SimpleNamespace(exp_name="batches", resume=False,
                                                device="cpu"), cfg)
    jt = types.SimpleNamespace(cfg=JsonHParams(**cfg), mel_cfg=JMelConfig(**MEL), hop=4,
                               max_phones=21, max_frames=50, spk2id=trainer.spk2id,
                               phone_dir=trainer.phone_dir)
    jt._phones = functools.partial(JVITSTrainer._phones, jt)
    utts = trainer._epoch_utts(0)[0]
    order = np.random.default_rng(0).permutation(len(trainer.utts))[:2]
    assert [u.uid for u in utts] == [trainer.utts[j].uid for j in order]
    ref = JVITSTrainer._make_batch(jt, utts)
    got = trainer.make_batch(utts)
    for k in ("phones", "phone_mask", "spec_mask", "audio", "sid"):
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    close(got["spec"], ref["spec"], what="spec")
