"""PyTorch port, GAN vocoder training on the CPU against the JAX package:
the three discriminators, the four losses, the mel's gradient, the
optimizer, and one whole D-then-G step.

Tiny sizes: BigVGAN with rates (4, 2), 32 channels and one resblock, the
fused activation on both sides (JAX runs the Pallas kernel in interpret
mode under ``jit``, the port the kernel's plain version); the mel of
`tests/test_hifigan.py`'s ``TINY_MEL``; discriminators at
``channel_mult=0.0625`` with periods (2, 3), one MSD scale and one MRD
resolution (the whole step runs the trainer's default MPD and MSD, with
period 2 alone to keep JAX's trace short; MRD and period 3 are held to
JAX on their own). Flax trees come from ``jax.eval_shape`` filled from a numpy
seed and reach the port through `utils/convert.from_flax`. Tolerances
(float32): logits and feature maps 1e-5 of each tensor's max|ref|; losses
1e-5 relative (the step's 1e-4); the mel's gradient 1e-4 of its max|ref|;
the optimizer's parameters 1e-6 absolute; the step's updated parameters
1e-6 absolute, under a learning rate of 2e-4 (about 1/200 of the largest
update).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from amphion_tpu.models.vocoders import discriminators as jdisc
from amphion_tpu.models.vocoders import losses as jlosses
from amphion_tpu.models.vocoders.bigvgan import BigVGANConfig as JBigVGANConfig
from amphion_tpu.models.vocoders.bigvgan import BigVGANGenerator as JBigVGAN
from amphion_tpu.models.vocoders.gan_trainer import CombinedDiscriminator as JCombined
from amphion_tpu.models.vocoders.gan_trainer import GANTrainConfig as JGANTrainConfig
from amphion_tpu.models.vocoders.gan_trainer import make_gan_train_step as j_make_step
from amphion_tpu.models.vocoders.gan_trainer import make_optimizer as j_make_optimizer
from amphion_tpu.ops import pallas_kernels as pk
from amphion_tpu.ops.mel import MelConfig as JMelConfig
from amphion_tpu.ops.mel import mel_spectrogram as j_mel
from amphion_tpu.runtime.train_state import TrainState as JTrainState
from amphion_tpu_torch.models.vocoders import discriminators as disc
from amphion_tpu_torch.models.vocoders import losses
from amphion_tpu_torch.models.vocoders.bigvgan import BigVGANConfig, BigVGANGenerator
from amphion_tpu_torch.models.vocoders.gan_trainer import (
    CombinedDiscriminator,
    GANTrainConfig,
    create_gan_states,
    make_gan_train_step,
    make_optimizer,
)
from amphion_tpu_torch.modules.weight_norm import WNConv1d, WNConv2d
from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram
from amphion_tpu_torch.utils.convert import from_flax, init_like_flax

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)

MEL = dict(sample_rate=8000, n_fft=64, win_size=32, hop_size=8, n_mel=16, fmax=4000)
GEN = dict(n_mel=16, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
           upsample_initial_channel=32, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1,),), use_pallas_act=True)
DISC = dict(use=("mpd", "msd", "mrd"), mpd_periods=(2, 3), msd_scales=1, channel_mult=0.0625,
            mrd_resolutions=((64, 16, 32),))
STEP_DISC = {**DISC, "use": ("mpd", "msd"), "mpd_periods": (2,)}  # the trainer's default set
B, FRAMES = 2, 32
T = FRAMES * 8


def _fill(shapes, seed: int):
    """Random leaves for a Flax tree of shapes: kernels normal, biases
    small, weight-norm scales in [0.3, 0.8], log-scale Snake parameters
    near 0."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name.endswith("/scale"):
            return rng.uniform(0.3, 0.8, s.shape).astype(np.float32)
        if name in ("alpha", "beta"):
            return (0.2 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(leaf, shapes))


def _audio(seed: int, b: int = B, t: int = T) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = np.arange(t)
    x = 0.4 * np.sin(n[None] * rng.uniform(0.05, 0.4, (b, 1))) + 0.05 * rng.standard_normal((b, t))
    return x.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _trees():
    pk._aa_polyphase_taps()  # probe the taps eagerly, not inside a trace
    g_tree = _fill(jax.eval_shape(JBigVGAN(JBigVGANConfig(**GEN)).init, jax.random.PRNGKey(0),
                                  jnp.zeros((1, FRAMES, 16)))["params"], 1)
    d_tree = _fill(jax.eval_shape(JCombined(**DISC).init, jax.random.PRNGKey(0),
                                  jnp.zeros((1, T)))["params"], 2)
    return g_tree, d_tree


def _models(disc: dict = DISC):
    """(Flax G tree, Flax D tree, JAX G, JAX D) of the tiny pair, D built
    from ``disc`` (its tree the full one's scopes and periods of it)."""
    g_tree, d_tree = _trees()
    scopes = {"mpd": "MultiPeriodDiscriminator_0", "msd": "MultiScaleDiscriminator_0",
              "mrd": "MultiResolutionDiscriminator_0"}
    d_tree = {scopes[u]: d_tree[scopes[u]] for u in disc["use"]}
    if "mpd" in disc["use"]:
        d_tree[scopes["mpd"]] = {f"PeriodDiscriminator_{i}": d_tree[scopes["mpd"]][
            f"PeriodDiscriminator_{i}"] for i in range(len(disc["mpd_periods"]))}
    return g_tree, d_tree, JBigVGAN(JBigVGANConfig(**GEN)), JCombined(**disc)


def _port_pair(disc: dict = DISC):
    g_tree, d_tree, _, _ = _models(disc)
    return (from_flax(BigVGANGenerator(BigVGANConfig(**GEN)), g_tree),
            from_flax(CombinedDiscriminator(**disc), d_tree))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    """A port feature map in JAX's layout."""
    return (x.permute(0, 2, 3, 1) if x.ndim == 4 else x).detach().numpy()


def _close(out: np.ndarray, ref: np.ndarray, tol: float) -> None:
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("kind", ["mpd", "msd", "mrd"])
def test_discriminator_matches_jax(kind):
    """Each discriminator's logits and every feature map, on a signal whose
    length is no multiple of the periods, MSD's pooling or MRD's hop."""
    _, d_tree, _, _ = _models()
    scope = {"mpd": "MultiPeriodDiscriminator_0", "msd": "MultiScaleDiscriminator_0",
             "mrd": "MultiResolutionDiscriminator_0"}[kind]
    jmod = {"mpd": jdisc.MultiPeriodDiscriminator((2, 3), 0.0625),
            "msd": jdisc.MultiScaleDiscriminator(2, 0.0625),
            "mrd": jdisc.MultiResolutionDiscriminator(((64, 16, 32),))}[kind]
    port = {"mpd": disc.MultiPeriodDiscriminator((2, 3), 0.0625),
            "msd": disc.MultiScaleDiscriminator(2, 0.0625),
            "mrd": disc.MultiResolutionDiscriminator(((64, 16, 32),))}[kind]
    tree = d_tree[scope]
    if kind == "msd":  # a second scale, so the average pooling runs
        tree = {**tree, "ScaleDiscriminator_1": _fill(
            jax.eval_shape(jdisc.ScaleDiscriminator(0.0625).init, jax.random.PRNGKey(0),
                           jnp.zeros((1, T)))["params"], 3)}
    from_flax(port, tree)
    x = _audio(4, t=T - 3)
    logits, fmaps = jax.jit(lambda a: jmod.apply({"params": tree}, a))(jnp.asarray(x))
    with torch.no_grad():
        p_logits, p_fmaps = port(torch.from_numpy(x))
    assert len(p_logits) == len(logits) and len(p_fmaps) == len(fmaps)
    for lo, ref in zip(p_logits, logits):
        _close(lo.numpy(), np.asarray(ref), 1e-5)
    for fm, ref_fm in zip(p_fmaps, fmaps):
        assert len(fm) == len(ref_fm)
        for f, ref in zip(fm, ref_fm):
            _close(_nhwc(f), np.asarray(ref), 1e-5)


def test_combined_discriminator_order_and_bridge():
    """The combined discriminator concatenates its parts' outputs in JAX's
    order (MPD, MSD, MRD), and `from_flax` reads one leaf per parameter."""
    _, d_tree, _, _ = _models()
    _, port = _port_pair()
    leaves = jax.tree_util.tree_leaves(d_tree)
    assert len(leaves) == len(list(port.parameters()))
    assert sum(x.size for x in leaves) == sum(p.numel() for p in port.parameters())
    x = torch.from_numpy(_audio(5))
    with torch.no_grad():
        logits, fmaps = port(x)
        parts = [port.MultiPeriodDiscriminator_0(x), port.MultiScaleDiscriminator_0(x),
                 port.MultiResolutionDiscriminator_0(x)]
    assert len(logits) == len(fmaps) == 2 + 1 + 1
    assert all(torch.equal(a, b) for a, b in zip(logits, [lo for p in parts for lo in p[0]]))
    assert all(torch.equal(a[-1], b[-1]) for a, b in zip(fmaps, [fm for p in parts for fm in p[1]]))


def test_weight_norm_conv2d_matches_flax():
    import flax.linen as fnn

    conv = fnn.WeightNorm(fnn.Conv(6, (3, 9), strides=(1, 2), padding=((1, 1), (4, 4))))
    x = np.random.default_rng(6).standard_normal((2, 10, 21, 3)).astype(np.float32)
    tree = _fill(jax.eval_shape(conv.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"], 7)
    ref = conv.apply({"params": tree}, jnp.asarray(x))
    port = WNConv2d(3, 6, (3, 9), (1, 2), (1, 4))
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(tree["layer_instance"]["kernel"].transpose(3, 2, 0, 1)))
        port.bias.copy_(torch.from_numpy(tree["layer_instance"]["bias"]))
        port.scale.copy_(torch.from_numpy(tree["layer_instance/kernel/scale"]))
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(_nhwc(out), np.asarray(ref), 1e-5)


def test_init_like_flax_draws_discriminators_with_flax_fan_in():
    """Every weight-normalised kernel of the egs MPD + MSD (at a quarter of
    its width) and of one MRD resolution is drawn with Flax's fan-in
    (in/groups times the kernel's taps), biases 0, scales 1."""
    d = init_like_flax(CombinedDiscriminator(("mpd", "msd", "mrd"), (2,), 1, 0.25,
                                             ((512, 50, 240),)),
                       torch.Generator().manual_seed(0))
    kinds = set()
    for name, mod in d.named_modules():
        if isinstance(mod, (WNConv1d, WNConv2d)):
            assert torch.all(mod.scale == 1) and torch.all(mod.bias == 0)
            if mod.weight.numel() >= 10000:
                std = mod.weight.std().item() * mod.weight[0].numel() ** 0.5
                assert abs(std - 1.0) < 0.05, (name, std)
                kinds.add((type(mod), getattr(mod, "groups", 1) > 1))
    assert kinds == {(WNConv2d, False), (WNConv1d, True), (WNConv1d, False)}


def test_losses_match_jax():
    rng = np.random.default_rng(8)
    shapes = [[(2, 5, 3), (2, 7)], [(2, 4, 2, 3)]]
    real = [[rng.standard_normal(s).astype(np.float32) for s in grp] for grp in shapes]
    fake = [[rng.standard_normal(s).astype(np.float32) for s in grp] for grp in shapes]
    lr = [rng.standard_normal((2, n)).astype(np.float32) for n in (9, 4, 6)]
    lf = [rng.standard_normal((2, n)).astype(np.float32) for n in (9, 4, 6)]
    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    cases = [
        (losses.feature_loss([t(g) for g in real], [t(g) for g in fake]),
         jlosses.feature_loss(real, fake)),
        (losses.discriminator_loss(t(lr), t(lf))[0], jlosses.discriminator_loss(lr, lf)[0]),
        (losses.generator_adv_loss(t(lf)), jlosses.generator_adv_loss(lf)),
    ]
    a, b = _audio(9), _audio(10)
    j_mel_loss = jax.jit(lambda x, y: jlosses.mel_loss(x, y, JMelConfig(**MEL)))
    cases.append((losses.mel_loss(torch.from_numpy(a), torch.from_numpy(b), MelConfig(**MEL)),
                  j_mel_loss(jnp.asarray(a), jnp.asarray(b))))
    for out, ref in cases:
        np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)


def test_mel_gradient_matches_jax_vjp():
    """`mel_spectrogram` under grad goes through `LogMelFn`, whose backward
    equals ``jax.vjp`` of JAX's mel."""
    y = _audio(11)
    g = np.random.default_rng(12).standard_normal((B, 16, FRAMES)).astype(np.float32)
    vjp = jax.jit(lambda a, c: jax.vjp(lambda x: j_mel(x, JMelConfig(**MEL)), a)[1](c)[0])
    ref = vjp(jnp.asarray(y), jnp.asarray(g))
    yt = torch.from_numpy(y).requires_grad_()
    mel = mel_spectrogram(yt, MelConfig(**MEL))
    assert type(mel.grad_fn).__name__ == "LogMelFnBackward"
    mel.backward(torch.from_numpy(g))
    _close(yt.grad.numpy(), np.asarray(ref), 1e-4)


@pytest.mark.parametrize("grad_clip", [None, 0.5], ids=["plain", "clip"])
def test_optimizer_matches_optax(grad_clip):
    """Three updates of AdamW under a decay of 0.5 every two updates, so the
    rate moves each update (continuous, not staircase), with b1 0.8 and
    b2 0.99 and optax's decay of the weights; with and without the global
    norm clip."""
    cfg = dict(lr=1e-2, lr_decay=0.5, decay_steps=2, grad_clip=grad_clip)
    rng = np.random.default_rng(13)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    tx = j_make_optimizer(JGANTrainConfig(**cfg))
    update = jax.jit(tx.update)
    jp, opt_state = params, jax.jit(tx.init)(params)
    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("a", "b")]
    opt = make_optimizer(tp, GANTrainConfig(**cfg))
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        updates, opt_state = update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.apply([torch.from_numpy(grads[k].copy()) for k in ("a", "b")])
        for k, p in zip(("a", "b"), tp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
    assert opt.count == 3


def test_gan_step_matches_jax():
    """One whole `make_gan_train_step` against JAX's jitted one from the same
    weights and batch: d_loss, g_adv, g_fm, g_mel and g_loss, and every
    updated parameter of G and of D."""
    g_tree, d_tree, jg, jd = _models(STEP_DISC)
    audio = _audio(14)
    mel = np.asarray(j_mel(jnp.asarray(audio), JMelConfig(**MEL))).transpose(0, 2, 1)
    jcfg = JGANTrainConfig()
    tx = j_make_optimizer(jcfg)

    def state(module, tree):
        tree = jax.tree_util.tree_map(jnp.array, tree)  # copies: the step donates them
        return JTrainState(step=jnp.zeros((), jnp.int32), params=tree,
                           opt_state=jax.jit(tx.init)(tree),
                           rng=jax.random.key(0), apply_fn=module.apply, tx=tx)

    jstep = j_make_step(JMelConfig(**MEL), jcfg)
    jgs, jds, jm = jstep(state(jg, g_tree), state(jd, d_tree),
                         {"audio": jnp.asarray(audio), "mel": jnp.asarray(mel)})

    gen, d = _port_pair(STEP_DISC)
    start = [copy.deepcopy(gen), copy.deepcopy(d)]
    gs, ds = create_gan_states(gen, d, GANTrainConfig())
    gs, ds, m = make_gan_train_step(MelConfig(**MEL))(
        gs, ds, {"audio": torch.from_numpy(audio), "mel": torch.from_numpy(mel.copy())})
    for k in ("d_loss", "g_adv", "g_fm", "g_mel", "g_loss"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, err_msg=k)
    assert gs.step == ds.step == 1
    ref_g, ref_d = _port_pair(STEP_DISC)
    from_flax(ref_g, jax.tree_util.tree_map(np.asarray, jgs.params))
    from_flax(ref_d, jax.tree_util.tree_map(np.asarray, jds.params))
    for i, (port, ref) in enumerate(((gen, ref_g), (d, ref_d))):
        for (name, p), r in zip(port.named_parameters(), ref.parameters()):
            np.testing.assert_allclose(p.detach().numpy(), r.detach().numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)
        moved = max((p - s).abs().max().item()
                    for p, s in zip(port.parameters(), start[i].parameters()))
        assert 1e-4 < moved < 1e-3  # each half took one step of about lr = 2e-4
