"""PyTorch port on the CPU against the JAX package: YIN F0, the NSF
excitation, the CQT, the MS-STFT and MS-SB-CQT discriminators, and two
whole D-then-G steps: HiFi-GAN against MPD (period 2) + one CQT scale, and
NSF-HiFiGAN with its excitation noise (JAX's own draws injected into the
port, which cannot reproduce JAX's random stream).

Tolerances (float32): F0 1e-4 relative where both are voiced, the voicing
equal; the excitation 1e-5 absolute; the CQT, logits and feature maps 1e-5
of each tensor's max|ref|; the steps' losses 1e-4 relative and updated
parameters 1e-6 absolute (learning rate 2e-4), as `tests/test_torch_gan.py`
holds BigVGAN's.
"""

import copy
import functools
import json
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.models.vocoders import discriminators as jdisc
from amphion_tpu.models.vocoders.gan_trainer import GANTrainConfig as JGANTrainConfig
from amphion_tpu.models.vocoders.gan_trainer import make_gan_train_step as j_make_step
from amphion_tpu.models.vocoders.gan_trainer import make_optimizer as j_make_optimizer
from amphion_tpu.models.vocoders.hifigan import HiFiGANConfig as JHiFiGANConfig
from amphion_tpu.models.vocoders.hifigan import HiFiGANGenerator as JHiFiGAN
from amphion_tpu.models.vocoders.nsf_hifigan import NSFHiFiGANConfig as JNSFConfig
from amphion_tpu.models.vocoders.nsf_hifigan import NSFHiFiGANGenerator as JNSF
from amphion_tpu.modules.nsf import SourceModuleHnNSF as JSource
from amphion_tpu.ops import cqt as jcqt
from amphion_tpu.ops.f0 import F0Config as JF0Config
from amphion_tpu.ops.f0 import yin_f0 as j_yin
from amphion_tpu.ops.mel import MelConfig as JMelConfig
from amphion_tpu.ops.mel import mel_spectrogram as j_mel
from amphion_tpu.runtime.train_state import TrainState as JTrainState
from amphion_tpu_torch.bins.vocoder.train import main
from amphion_tpu_torch.data.audio_io import save_wav
from amphion_tpu_torch.data.metadata import Utterance, save_metadata
from amphion_tpu_torch.models.vocoders import discriminators as disc
from amphion_tpu_torch.models.vocoders.gan_trainer import (
    CombinedDiscriminator,
    GANTrainConfig,
    create_gan_states,
    make_gan_train_step,
)
from amphion_tpu_torch.models.vocoders.hifigan import HiFiGANConfig, HiFiGANGenerator
from amphion_tpu_torch.models.vocoders.nsf_hifigan import NSFHiFiGANConfig, NSFHiFiGANGenerator
from amphion_tpu_torch.modules.nsf import SourceModuleHnNSF
from amphion_tpu_torch.ops import cqt
from amphion_tpu_torch.ops.f0 import F0Config, yin_f0
from amphion_tpu_torch.ops.mel import MelConfig
from amphion_tpu_torch.utils.convert import from_flax

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MEL = dict(sample_rate=8000, n_fft=64, win_size=32, hop_size=8, n_mel=16, fmax=4000)
HIFI = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),), n_mel=16)
NSF = dict(sample_rate=8000, num_harmonics=3)
MPD = ((2,), 0.0625)
CQT_SCALE = dict(n_octaves=3, bins_per_octave=12, fmin=500.0, filters=8)  # one scale, hop 64
B, FRAMES = 2, 32
T = FRAMES * 8


def fill(shapes, seed: int):
    """Random leaves for a Flax tree of shapes: kernels normal, biases
    small, weight-norm scales in [0.3, 0.8]."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name.endswith("/scale"):
            return rng.uniform(0.3, 0.8, s.shape).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(leaf, shapes))


def audio(seed: int, b: int = B, t: int = T) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = np.arange(t)
    x = 0.4 * np.sin(n[None] * rng.uniform(0.05, 0.4, (b, 1))) + 0.05 * rng.standard_normal((b, t))
    return x.astype(np.float32)


def _close(out: np.ndarray, ref: np.ndarray, tol: float) -> None:
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-30))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return (x.permute(0, 2, 3, 1) if x.ndim == 4 else x).detach().numpy()


# -- YIN ---------------------------------------------------------------------------

F0_CFG = dict(sample_rate=16000, hop_size=80, f0_min=60.0, f0_max=800.0, frame_length=512)


def _voices() -> np.ndarray:
    """Two 0.4 s rows at 16 kHz: a 220 Hz tone with harmonics, then
    silence, then noise; a gliding 130-330 Hz tone, then a 600 Hz one."""
    sr, n = 16000, 6400
    t = np.arange(n) / sr
    rng = np.random.default_rng(3)
    a = sum(np.sin(2 * np.pi * 220 * k * t) / k for k in (1, 2, 3))
    a[2400:3600] = 0.0
    a[3600:] = 0.3 * rng.standard_normal(n - 3600)
    glide = 2 * np.pi * np.cumsum(130 + 200 * t / t[-1]) / sr
    b = np.where(t < 0.25, np.sin(glide), np.sin(2 * np.pi * 600 * t))
    return (0.5 * np.stack([a, b])).astype(np.float32)


def test_yin_matches_jax():
    """F0 within 1e-4 relative where both are voiced, the voicing equal, on
    tones, a glide, silence and noise; the 220 Hz stretch within 1 %."""
    y = _voices()
    f0_ref, v_ref = (np.asarray(a) for a in j_yin(jnp.asarray(y), JF0Config(**F0_CFG)))
    f0, voiced = (a.numpy() for a in yin_f0(torch.from_numpy(y), F0Config(**F0_CFG)))
    assert f0.shape == f0_ref.shape == (2, 6400 // 80)
    np.testing.assert_array_equal(voiced, v_ref)
    both = voiced & v_ref
    assert both.sum() > 80
    np.testing.assert_allclose(f0[both], f0_ref[both], rtol=1e-4)
    assert np.all(np.abs(f0[0, 5:25] / 220 - 1) < 0.01)
    assert not voiced[0, 32:42].any()


# -- the NSF excitation --------------------------------------------------------------


def test_nsf_source_matches_jax_on_both_paths():
    """`SourceModuleHnNSF` against JAX's: the deterministic path (rng None),
    and the random path with JAX's initial phases and noise, drawn from the
    key as JAX's SineGen draws them, given to the port."""
    h, t = NSF["num_harmonics"], 3 * 64
    rng = np.random.default_rng(4)
    f0 = np.repeat(rng.uniform(100, 500, (B, 3)), 64, axis=1).astype(np.float32)
    f0[1, 64:128] = 0.0  # an unvoiced stretch
    jmod = JSource(NSF["sample_rate"], h)
    tree = fill(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, t)))["params"], 5)
    port = from_flax(SourceModuleHnNSF(NSF["sample_rate"], h), tree)
    key = jax.random.key(7)
    _, r1, r2 = jax.random.split(key, 3)
    init_phase = np.array(jax.random.uniform(r1, (B, 1, h + 1)).at[:, :, 0].set(0.0))
    noise = np.array(jax.random.normal(r2, (B, t, h + 1)))
    run = jax.jit(lambda p, f, k: jmod.apply({"params": p}, f, k))
    for k, kw in ((None, {}), (key, {"init_phase": torch.from_numpy(init_phase),
                                     "noise": torch.from_numpy(noise)})):
        ref, ref_uv = run(tree, jnp.asarray(f0), k)
        with torch.no_grad():
            out, uv = port(torch.from_numpy(f0), **kw)
        np.testing.assert_array_equal(uv.numpy(), np.asarray(ref_uv))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    # the port's own draws take the random path, reproducibly
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    with torch.no_grad():
        a, b = port(torch.from_numpy(f0), g())[0], port(torch.from_numpy(f0), g())[0]
        det = port(torch.from_numpy(f0))[0]
    assert torch.equal(a, b) and not torch.allclose(a, det)


# -- the CQT -------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(sr=16000, hop_length=64, fmin=500.0, n_bins=36,
                                     bins_per_octave=12),
                                dict(sr=16000, hop_length=32, fmin=100.0, n_bins=40,
                                     bins_per_octave=24)], ids=["3oct", "2oct_cut"])
@pytest.mark.parametrize("output", ["complex", "magnitude"])
def test_cqt_matches_jax(kw, output):
    """Both output modes, at three whole octaves and at two octaves cut to
    fewer bins than they hold."""
    x = audio(6, t=2048)
    ref = np.asarray(jax.jit(lambda a: jcqt.cqt(a, output=output, **kw))(jnp.asarray(x)))
    out = cqt.cqt(torch.from_numpy(x), output=output, **kw).numpy()
    _close(out, ref, 1e-5)
    assert out.shape[1] == kw["n_bins"]


def test_cqt_guards_match_jax():
    x = torch.zeros(1, 1024)
    for fn in (jcqt.cqt, cqt.cqt):
        with pytest.raises(ValueError, match="divisible"):
            fn(x.numpy() if fn is jcqt.cqt else x, 16000, hop_length=66, n_bins=36,
               bins_per_octave=12)
        with pytest.raises(ValueError, match="Nyquist"):
            fn(x.numpy() if fn is jcqt.cqt else x, 8000, hop_length=64, fmin=3000.0, n_bins=12,
               bins_per_octave=12)


# -- MS-STFT and MS-SB-CQT -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["msstft", "mssbcqt"])
def test_discriminator_matches_jax(kind):
    """Logits and every feature map of MS-STFT (two resolutions, 8 channels)
    and of MS-SB-CQT (one scale of three octaves), on a signal whose length
    is no multiple of the hops."""
    if kind == "msstft":
        jmod = jdisc.MultiSTFTDiscriminator(((64, 16, 64), (32, 8, 32)), 8)
        port = disc.MultiSTFTDiscriminator(((64, 16, 64), (32, 8, 32)), 8)
    else:
        jmod = jdisc.MultiScaleSubBandCQTDiscriminator(8000, (64,), (3,), (24,))
        port = disc.MultiScaleSubBandCQTDiscriminator(8000, (64,), (3,), (24,))
    x = audio(7, t=T + 37)
    tree = fill(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, T)))["params"], 8)
    from_flax(port, tree)
    logits, fmaps = jax.jit(lambda p, a: jmod.apply({"params": p}, a))(tree, jnp.asarray(x))
    with torch.no_grad():
        p_logits, p_fmaps = port(torch.from_numpy(x))
    assert len(p_logits) == len(logits) and len(p_fmaps) == len(fmaps)
    for lo, ref in zip(p_logits, logits):
        _close(lo.numpy(), np.asarray(ref), 1e-5)
    for fm, ref_fm in zip(p_fmaps, fmaps):
        assert len(fm) == len(ref_fm) == 5
        for f, ref in zip(fm, ref_fm):
            _close(_nhwc(f), np.asarray(ref), 1e-5)


def test_combined_discriminator_takes_msstft_and_mssbcqt():
    """The combined discriminator builds all five kinds in JAX's order, with
    the sample rate passed to MS-SB-CQT's three scales (JAX's trees of each
    reach the port in `test_discriminator_matches_jax`)."""
    port = CombinedDiscriminator(("mssbcqt", "msstft", "mrd", "msd", "mpd"), (2,), 1, 0.0625,
                                 ((64, 16, 32),), sample_rate=22050)
    assert [type(s).__name__ for s in port.subs] == [
        "MultiPeriodDiscriminator", "MultiScaleDiscriminator", "MultiResolutionDiscriminator",
        "MultiSTFTDiscriminator", "MultiScaleSubBandCQTDiscriminator"]
    cqts = port.MultiScaleSubBandCQTDiscriminator_0.subs
    assert [(s.sample_rate, s.hop_length, s.bins_per_octave) for s in cqts] == [
        (22050, 512, 24), (22050, 256, 36), (22050, 256, 48)]
    assert [s.n_fft for s in port.MultiSTFTDiscriminator_0.subs] == [1024, 2048, 512]
    with pytest.raises(ValueError, match="unknown"):
        CombinedDiscriminator(("mpd", "mcd"))


# -- whole steps -----------------------------------------------------------------------


class JMPDCQT(fnn.Module):
    """JAX's MPD (period 2) and one CQT scale as one discriminator."""

    @fnn.compact
    def __call__(self, x):
        lo, fm = jdisc.MultiPeriodDiscriminator(*MPD)(x)
        lq, fq = jdisc.SubBandCQTDiscriminator(8000, 64, **CQT_SCALE)(x)
        return lo + [lq], fm + [fq]


class MPDCQT(torch.nn.Module):
    """The port's MPD (period 2) and one CQT scale, under JAX's scope names."""

    def __init__(self):
        super().__init__()
        self.MultiPeriodDiscriminator_0 = disc.MultiPeriodDiscriminator(*MPD)
        self.SubBandCQTDiscriminator_0 = disc.SubBandCQTDiscriminator(8000, 64, **CQT_SCALE)

    def forward(self, x):
        lo, fm = self.MultiPeriodDiscriminator_0(x)
        lq, fq = self.SubBandCQTDiscriminator_0(x)
        return lo + [lq], fm + [fq]


def _f0(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(150, 400, (B, 1)) * (1 + 0.1 * np.sin(np.arange(FRAMES) / 3.0))[None]
    f0[:, 10:16] = 0.0
    return f0.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _step_case(name: str):
    """(JAX G, JAX D, G tree, D tree, port G, port D, batch (numpy), gen_args)."""
    x = audio(10)
    mel = np.asarray(j_mel(jnp.asarray(x), JMelConfig(**MEL))).transpose(0, 2, 1)
    batch = {"audio": x, "mel": np.ascontiguousarray(mel)}
    if name == "hifigan_cqt":
        jg, g = JHiFiGAN(JHiFiGANConfig(**HIFI)), HiFiGANGenerator(HiFiGANConfig(**HIFI))
        jd, d = JMPDCQT(), MPDCQT()
        g_args = (jnp.zeros((1, FRAMES, 16)),)
        gen_args = ("mel",)
    else:
        jg = JNSF(JNSFConfig(base=JHiFiGANConfig(**HIFI), **NSF))
        g = NSFHiFiGANGenerator(NSFHiFiGANConfig(base=HiFiGANConfig(**HIFI), **NSF))
        jd, d = jdisc.MultiPeriodDiscriminator(*MPD), disc.MultiPeriodDiscriminator(*MPD)
        batch["f0"] = _f0(11)
        g_args = (jnp.zeros((1, FRAMES, 16)), jnp.zeros((1, FRAMES)), None)
        gen_args = ("mel", "f0")
    g_tree = fill(jax.eval_shape(jg.init, jax.random.PRNGKey(0), *g_args)["params"], 12)
    d_tree = fill(jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.zeros((1, T)))["params"], 13)
    return jg, jd, g_tree, d_tree, g, d, batch, gen_args


@pytest.mark.parametrize("name", ["hifigan_cqt", "nsf_rng"])
def test_gan_step_matches_jax(name):
    """One whole `make_gan_train_step` against JAX's jitted one from the same
    weights and batch: every loss, and every updated parameter of G and D.
    NSF-HiFiGAN runs with ``use_rng``: JAX splits the G state's key once a
    step and its SineGen splits that draw; the port's step asks the
    generator's ``draw`` once and feeds both forwards, here given JAX's
    draws."""
    jg, jd, g_tree, d_tree, g, d, batch, gen_args = _step_case(name)
    use_rng = name == "nsf_rng"
    jcfg = JGANTrainConfig()
    tx = j_make_optimizer(jcfg)

    def state(module, tree):
        tree = jax.tree_util.tree_map(jnp.array, tree)  # copies: the step donates them
        return JTrainState(step=jnp.zeros((), jnp.int32), params=tree,
                           opt_state=jax.jit(tx.init)(tree),
                           rng=jax.random.key(0), apply_fn=module.apply, tx=tx)

    jstep = j_make_step(JMelConfig(**MEL), jcfg, gen_args=gen_args, use_rng=use_rng)
    jgs, jds, jm = jstep(state(jg, g_tree), state(jd, d_tree),
                         {k: jnp.asarray(v) for k, v in batch.items()})

    gen, dis = from_flax(copy.deepcopy(g), g_tree), from_flax(copy.deepcopy(d), d_tree)
    if use_rng:
        _, sub = jax.random.split(jax.random.key(0))
        _, r1, r2 = jax.random.split(sub, 3)
        h = NSF["num_harmonics"] + 1
        draws = {"init_phase": torch.from_numpy(np.array(
                     jax.random.uniform(r1, (B, 1, h)).at[:, :, 0].set(0.0))),
                 "noise": torch.from_numpy(np.array(jax.random.normal(r2, (B, T, h))))}
        calls = []
        gen.draw = lambda mel, f0, generator: calls.append(generator) or draws
    start = [copy.deepcopy(gen), copy.deepcopy(dis)]
    gs, ds = create_gan_states(gen, dis, GANTrainConfig())
    gs, ds, m = make_gan_train_step(MelConfig(**MEL), gen_args=gen_args, use_rng=use_rng)(
        gs, ds, {k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    if use_rng:
        assert calls == [gs.generator]  # one draw a step, from the G state's generator
    for k in ("d_loss", "g_adv", "g_fm", "g_mel", "g_loss"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4, err_msg=k)
    ref_g = from_flax(copy.deepcopy(g), jax.tree_util.tree_map(np.asarray, jgs.params))
    ref_d = from_flax(copy.deepcopy(d), jax.tree_util.tree_map(np.asarray, jds.params))
    for i, (port, ref) in enumerate(((gen, ref_g), (dis, ref_d))):
        for (pname, p), r in zip(port.named_parameters(), ref.parameters()):
            np.testing.assert_allclose(p.detach().numpy(), r.detach().numpy(), rtol=0,
                                       atol=1e-6, err_msg=pname)
        moved = max((p - s).abs().max().item()
                    for p, s in zip(port.parameters(), start[i].parameters()))
        assert 1e-4 < moved < 1e-3  # each half took one step of about lr = 2e-4


# -- the NSF trainer -------------------------------------------------------------------


def test_nsf_trainer_feeds_yin_f0_and_draws_a_step(tmp_path):
    """`bins/vocoder/train.main` on the nsfhifigan recipe cut to tiny widths:
    the batch carries `yin_f0` of its audio cut to the mel's frames, each
    step draws the excitation from the G state's generator, losses finite."""
    rng = np.random.default_rng(0)
    utts = []
    for i in range(2):  # clips of a 64-frame segment: longer than YIN's reflect padding
        x = 0.3 * np.sin(2 * np.pi * 200 * (1 + i) * np.arange(512) / 8000)
        save_wav(tmp_path / f"{i}.wav", x.astype(np.float32) + 0.01 * rng.standard_normal(512)
                 .astype(np.float32), 8000)
        utts.append(Utterance("tiny", f"u{i}", str(tmp_path / f"{i}.wav"), 0.064))
    save_metadata(tmp_path / "data" / "tiny" / "train.json", utts)
    cfg = {"base_config": str(REPO / "egs/vocoder/gan/nsfhifigan/exp_config.json"),
           "dataset": ["tiny"], "log_dir": str(tmp_path / "ckpts"),
           "preprocess": {"processed_dir": str(tmp_path / "data"), **MEL, "f0_min": 60,
                          "f0_max": 1000},
           "model": {"nsf_hifigan": {"num_harmonics": 3, "base": {**HIFI, "resblock": "1"}},
                     "mpd_periods": [2], "msd_scales": 1,
                     "discriminator_channel_mult_factor": 0.0625},
           "train": {"batch_size": 2, "segment_frames": 64, "max_steps": 1, "log_interval": 1,
                     "metrics_path": str(tmp_path / "m.jsonl")}}
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    trainer = main(["--config", str(tmp_path / "c.json"), "--exp_name", "nsf", "--device", "cpu"])
    assert trainer.is_nsf and trainer.f0_cfg.sample_rate == 8000
    batch = trainer._make_batch([0, 1], np.random.default_rng(0))
    f0, _ = yin_f0(batch["audio"], trainer.f0_cfg)
    assert batch["f0"].shape == batch["mel"].shape[:2]
    assert torch.equal(batch["f0"], f0[:, : batch["mel"].shape[1]])
    fresh = torch.Generator().manual_seed(trainer.seed + 2)
    assert not torch.equal(trainer.loop.states["g"].generator.get_state(), fresh.get_state())
    row = json.loads((tmp_path / "m.jsonl").read_text())
    assert all(np.isfinite(row[k]) for k in ("d_loss", "g_loss", "g_mel"))
