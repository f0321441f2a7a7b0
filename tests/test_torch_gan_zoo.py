"""PyTorch port, the GAN vocoder zoo on the CPU against the JAX package:
each generator's forward (HiFi-GAN V1 and V3 with global conditioning,
MelGAN at strides 5 and 3, APNet with its features, Vocos as a GAN
generator, NSF-HiFiGAN's deterministic excitation) through
`utils/convert.from_flax`, `build_generator` on every `egs/vocoder/gan`
recipe beside JAX's, and both vocoder CLIs on two-step runs of HiFi-GAN
and Vocos, with the raises that JAX shares.

Tiny widths: two upsample stages, at most 64 channels, one resblock
kernel; an 8 kHz mel with hop 8 or 15. Flax trees come from
``jax.eval_shape`` filled from a numpy seed. Tolerance: float32, 1e-4
absolute on ``tanh`` outputs; APNet's and Vocos's iSTFT outputs are not
bounded, so theirs is 1e-4 of max|ref|.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.models.vocoders.apnet import APNetConfig as JAPNetConfig
from amphion_tpu.models.vocoders.apnet import APNetGenerator as JAPNet
from amphion_tpu.models.vocoders.hifigan import HiFiGANConfig as JHiFiGANConfig
from amphion_tpu.models.vocoders.hifigan import HiFiGANGenerator as JHiFiGAN
from amphion_tpu.models.vocoders.melgan import MelGANConfig as JMelGANConfig
from amphion_tpu.models.vocoders.melgan import MelGANGenerator as JMelGAN
from amphion_tpu.models.vocoders.nsf_hifigan import NSFHiFiGANConfig as JNSFConfig
from amphion_tpu.models.vocoders.nsf_hifigan import NSFHiFiGANGenerator as JNSF
from amphion_tpu.models.vocoders.vocos import VocosConfig as JVocosConfig
from amphion_tpu.models.vocoders.vocos import VocosGenerator as JVocos
from amphion_tpu.runtime import vocoder_trainer as jtrainer
from amphion_tpu.utils.config import load_config as j_load_config
from amphion_tpu_torch.bins.vocoder import inference
from amphion_tpu_torch.bins.vocoder.train import build_trainer, main
from amphion_tpu_torch.data.audio_io import load_wav, save_wav
from amphion_tpu_torch.data.metadata import Utterance, save_metadata
from amphion_tpu_torch.models.vocoders.apnet import APNetConfig, APNetGenerator
from amphion_tpu_torch.models.vocoders.hifigan import HiFiGANConfig, HiFiGANGenerator
from amphion_tpu_torch.models.vocoders.melgan import MelGANConfig, MelGANGenerator
from amphion_tpu_torch.models.vocoders.nsf_hifigan import NSFHiFiGANConfig, NSFHiFiGANGenerator
from amphion_tpu_torch.models.vocoders.vocos import VocosConfig, VocosGenerator
from amphion_tpu_torch.runtime.vocoder_trainer import GANVocoderTrainer, build_generator
from amphion_tpu_torch.utils.config import load_config
from amphion_tpu_torch.utils.convert import from_flax, init_like_flax

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N_MEL, FRAMES, B = 16, 24, 2
HIFI = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=32,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),), n_mel=N_MEL)
HIFI_V3 = {**HIFI, "resblock": "2", "resblock_kernel_sizes": (3, 5),
           "resblock_dilation_sizes": ((1, 3), (1, 3))}
MELGAN = dict(n_mel=N_MEL, upsample_rates=(5, 3), ngf=4, n_residual_layers=2)
APNET = dict(n_mel=N_MEL, channels=32, n_fft=32, hop_size=8, win_size=32,
             resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),))
VOCOS = dict(n_mel=N_MEL, dim=32, intermediate_dim=48, num_layers=2, n_fft=32, hop_size=8)
GIN = 4


def fill(shapes, seed: int):
    """Random leaves for a Flax tree of shapes: kernels normal, biases and
    Vocos's layer scales small, weight-norm scales in [0.3, 0.8]."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name.endswith("/scale"):
            return rng.uniform(0.3, 0.8, s.shape).astype(np.float32)
        if name in ("bias", "gamma"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(leaf, shapes))


def f0_track(seed: int, n: int, b: int = B) -> np.ndarray:
    """A frame-rate F0 (Hz) of 150-400 Hz with unvoiced (0) stretches."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(150, 400, (b, 1)) * (1 + 0.1 * np.sin(np.arange(n) / 3.0))[None]
    f0[:, n // 3: n // 2] = 0.0
    return f0.astype(np.float32)


# name → (JAX module, port module, extra inputs (numpy) after the mel, tolerance kind)
def _case(name: str):
    rng = np.random.default_rng(7)
    if name == "hifigan":
        return JHiFiGAN(JHiFiGANConfig(**HIFI)), HiFiGANGenerator(HiFiGANConfig(**HIFI)), ()
    if name == "hifigan_v3_cond":
        g = rng.standard_normal((B, 1, GIN)).astype(np.float32)
        return (JHiFiGAN(JHiFiGANConfig(**HIFI_V3)),
                HiFiGANGenerator(HiFiGANConfig(**HIFI_V3), gin_channels=GIN), (g,))
    if name == "melgan":
        return JMelGAN(JMelGANConfig(**MELGAN)), MelGANGenerator(MelGANConfig(**MELGAN)), ()
    if name == "apnet":
        return JAPNet(JAPNetConfig(**APNET)), APNetGenerator(APNetConfig(**APNET)), ()
    if name == "vocos":
        return JVocos(JVocosConfig(**VOCOS)), VocosGenerator(VocosConfig(**VOCOS)), ()
    assert name == "nsf_hifigan"
    cfg = dict(sample_rate=8000, num_harmonics=3)
    return (JNSF(JNSFConfig(base=JHiFiGANConfig(**HIFI), **cfg)),
            NSFHiFiGANGenerator(NSFHiFiGANConfig(base=HiFiGANConfig(**HIFI), **cfg)),
            (f0_track(8, FRAMES),))


@functools.lru_cache(maxsize=None)
def _pair(name: str):
    """(JAX module, its filled tree, the port module carrying it, extras)."""
    jmod, port, extra = _case(name)
    mel = jnp.zeros((1, FRAMES, N_MEL))
    args = [jnp.asarray(e[:1]) for e in extra]
    if name == "nsf_hifigan":
        args.append(None)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), mel, *args)["params"]
    tree = fill(shapes, {"hifigan": 1, "hifigan_v3_cond": 2, "melgan": 3, "apnet": 4,
                         "vocos": 5, "nsf_hifigan": 6}[name])
    if name == "apnet":  # a log-amplitude of order 1
        tree["WeightNorm_1"]["asp_output_conv/kernel/scale"] *= 0.05
    return jmod, tree, from_flax(port, tree), extra


def _mel(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, FRAMES, N_MEL)).astype(np.float32)


@pytest.mark.parametrize("name", ["hifigan", "hifigan_v3_cond", "melgan", "apnet", "vocos",
                                  "nsf_hifigan"])
def test_generator_matches_jax(name):
    """The forward of each generator against its JAX module, and the bridge
    reads one Flax leaf per port parameter."""
    jmod, tree, port, extra = _pair(name)
    leaves = jax.tree_util.tree_leaves(tree)
    assert len(leaves) == len(list(port.parameters()))
    assert sum(x.size for x in leaves) == sum(p.numel() for p in port.parameters())
    mel = _mel(11)
    tail = (None,) if name == "nsf_hifigan" else ()  # JAX's deterministic excitation
    ref = np.asarray(jax.jit(lambda p, m, *e: jmod.apply({"params": p}, m, *e, *tail))(
        tree, jnp.asarray(mel), *[jnp.asarray(e) for e in extra]))
    with torch.no_grad():
        out = port(torch.from_numpy(mel), *[torch.from_numpy(e) for e in extra]).numpy()
    hop = {"melgan": 15}.get(name, 8)
    assert out.shape == ref.shape == (B, FRAMES * hop)
    scale = np.abs(ref).max() if name in ("apnet", "vocos") else 1.0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * scale)


def test_apnet_features_match_jax():
    """APNet's ``return_features``: log-amplitude, phase, real and imaginary
    parts, each within 1e-4 of its max|ref| (the phase where the amplitude
    is not negligible: atan2 of two near-zero parts may wrap)."""
    jmod, tree, port, _ = _pair("apnet")
    mel = _mel(12)
    ref_audio, ref = jax.jit(lambda p, m: jmod.apply({"params": p}, m, return_features=True))(
        tree, jnp.asarray(mel))
    with torch.no_grad():
        audio, feats = port(torch.from_numpy(mel), return_features=True)
    np.testing.assert_allclose(audio.numpy(), np.asarray(ref_audio), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(ref_audio)).max())
    logamp, phase, real, imag = (f.numpy() for f in feats)
    rl, rp, rr, ri = (np.asarray(r) for r in ref)
    assert logamp.shape == phase.shape == rl.shape == (B, FRAMES, 17)
    assert real.shape == imag.shape == (B, 17, FRAMES)
    for out, want in ((logamp, rl), (real, rr), (imag, ri)):
        np.testing.assert_allclose(out, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # the phase branch's parts themselves: atan2 wraps only where they are ~0
    wrap = np.abs(np.angle(np.exp(1j * (phase - rp))))
    assert np.all(wrap <= 1e-3), wrap.max()


def test_init_like_flax_draws_every_new_generator():
    """`init_like_flax` draws every parameter of each new generator (the
    strided plain convs and the Dense of NSF, Vocos's ConvNeXt layer scale)
    with Flax's rules."""
    for name in ("hifigan_v3_cond", "melgan", "apnet", "vocos", "nsf_hifigan"):
        _, port, _ = _case(name)
        init_like_flax(port, torch.Generator().manual_seed(0))
        if name == "vocos":
            assert torch.all(port.block_0.gamma == 1e-6)
        if name == "nsf_hifigan":
            # (ch, 1, 4): a normal truncated at two of its deviations, rescaled
            # to variance 1/fan_in with fan_in 4
            bound = 2 * 0.5 / 0.87962566103423978
            w = port.noise_conv_0.weight
            assert torch.all(port.noise_conv_0.bias == 0) and w.abs().max() <= bound + 1e-6


RECIPES = ["hifigan", "melgan", "apnet", "vocos", "nsfhifigan", "tfr_enhanced_hifigan"]


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_generators_and_hops_match_jax(recipe):
    """`build_generator` on each egs/vocoder/gan recipe builds the generator
    JAX builds, with JAX's hop; the preprocess hop equals it everywhere but
    apnet, whose recipe has no ``model.apnet`` block (256 against 120)."""
    path = REPO / "egs/vocoder/gan" / recipe / "exp_config.json"
    cfg, jcfg = load_config(path), j_load_config(str(path))
    gen, hop = build_generator(cfg, cfg["preprocess"]["n_mel"])
    jgen, jhop = jtrainer.build_generator(jcfg, jcfg.preprocess.n_mel)
    assert hop == jhop
    assert type(gen).__name__ == type(jgen).__name__
    assert (hop == cfg["preprocess"]["hop_size"]) == (recipe != "apnet")


# -- the CLIs --------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two 8 kHz clips of 300-400 samples and a config maker over an egs
    recipe cut to tiny widths (mel hop 8, MPD of period 2 at a sixteenth of
    its width, batch 2 of 32 frames)."""
    root = tmp_path_factory.mktemp("gan_zoo")
    rng = np.random.default_rng(0)
    utts = []
    for i in range(2):
        n = int(rng.integers(300, 400))
        x = 0.3 * np.sin(np.arange(n) * rng.uniform(0.05, 0.3)) + 0.02 * rng.standard_normal(n)
        save_wav(root / "wav" / f"{i}.wav", x.astype(np.float32), 8000)
        utts.append(Utterance("tiny", f"u{i}", str(root / "wav" / f"{i}.wav"), n / 8000))
    save_metadata(root / "data" / "tiny" / "train.json", utts)

    def config(name: str, recipe: str, model: dict, **top) -> Path:
        cfg = {"base_config": str(REPO / "egs/vocoder/gan" / recipe / "exp_config.json"),
               "dataset": ["tiny"], "log_dir": str(root / "ckpts"),
               "preprocess": {"processed_dir": str(root / "data"), "sample_rate": 8000,
                              "n_fft": 64, "win_size": 32, "hop_size": 8, "n_mel": N_MEL,
                              "fmax": 4000},
               "model": {"discriminators": ["mpd"], "mpd_periods": [2],
                         "discriminator_channel_mult_factor": 0.0625, **model},
               "train": {"batch_size": 2, "segment_frames": 32, "log_interval": 1,
                         "max_steps": 2, "metrics_path": str(root / f"{name}.jsonl")},
               **top}
        path = root / f"{name}.json"
        path.write_text(json.dumps(cfg))
        return path

    return root, config


HIFI_BLOCK = {"resblock": "1", "upsample_rates": [4, 2], "upsample_kernel_sizes": [8, 4],
              "upsample_initial_channel": 32, "resblock_kernel_sizes": [3],
              "resblock_dilation_sizes": [[1, 3]]}


@pytest.mark.parametrize("recipe,model,top", [
    ("hifigan", {"hifigan": HIFI_BLOCK}, {}),
    ("vocos", {"vocos": {"n_fft": 32, "hop_size": 8}}, {"model_type": "Vocos"}),
], ids=["hifigan", "vocos"])
def test_train_and_inference_clis(corpus, recipe, model, top):
    """Two steps through `bins/vocoder/train.main` (``Vocos`` is the GAN
    trainer, as in JAX), then copy synthesis of every clip from the last
    checkpoint through `bins/vocoder/inference.main`."""
    root, config = corpus
    trainer = main(["--config", str(config(recipe, recipe, model, **top)), "--exp_name",
                    recipe, "--device", "cpu"])
    assert isinstance(trainer, GANVocoderTrainer)
    rows = [json.loads(x) for x in (root / f"{recipe}.jsonl").read_text().splitlines()]
    keys = ("d_loss", "g_loss", "g_adv", "g_fm", "g_mel")
    assert len(rows) == 2 and all(np.isfinite(r[k]) for r in rows for k in keys)
    assert trainer.loop.states["g"].step == 2
    snap = root / "ckpts" / recipe / "exp_config.json"
    records = inference.main(["--config", str(snap), "--checkpoint_path",
                              str(root / "ckpts" / recipe / "checkpoint"), "--output_dir",
                              str(root / f"out_{recipe}"), "--mode", "from_audio",
                              "--audio_dir", str(root / "wav"), "--device", "cpu"])
    assert len(records) == 2
    for r in records:
        wav, sr = load_wav(r["path"], sr=8000)
        src, _ = load_wav(root / "wav" / Path(r["path"]).name, sr=8000)
        assert sr == 8000 and len(wav) == r["samples"] == len(src) // 8 * 8
        assert np.isfinite(wav).all()


def test_clis_raise_where_jax_cannot_run(corpus):
    """The apnet recipe as written fails the hop check as JAX's assert does;
    NSF-HiFiGAN's copy synthesis raises (it needs F0); DiffWave is not
    ported."""
    root, config = corpus
    with pytest.raises(ValueError, match="generator hop 256 != preprocess hop 8"):
        main(["--config", str(config("apnet", "apnet", {})), "--exp_name", "apnet",
              "--device", "cpu"])
    nsf = config("nsf", "nsfhifigan", {})
    with pytest.raises(NotImplementedError, match="F0"):
        inference.main(["--config", str(nsf), "--checkpoint_path", str(root / "none"),
                        "--output_dir", str(root / "nsf_out"), "--mode", "from_audio",
                        "--audio_dir", str(root / "wav"), "--device", "cpu"])
    diff = config("diffwave", "hifigan", {}, model_type="DiffusionVocoder")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A5"):
        build_trainer(type("A", (), {"device": "cpu"})(), load_config(diff))
