"""PyTorch port, BigVGAN copy synthesis on the CPU: the weight-normalised
convolutions, the generator with and without the fused activation
(kernel 2's plain version against the Pallas kernel in interpret mode),
the weight bridge and initializers, and the vocoder inference CLI, against
the JAX package.

One tiny generator (2 stages, 16 channels, one resblock kernel, dilations
(1, 3)) is built per setting and shared through module-scoped fixtures:
its Flax tree comes from ``jax.eval_shape`` filled from a numpy seed, and
the port gets it through `utils/convert.from_flax`. Tolerances (float32):
waveforms 1e-5 absolute; the CLI's wav files 1e-4 (PCM16 rounding);
convolutions 1e-5.
"""

import dataclasses
import functools
import runpy
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)


from amphion_tpu.models.vocoders.bigvgan import BigVGANConfig as JBigVGANConfig
from amphion_tpu.models.vocoders.bigvgan import BigVGANGenerator as JBigVGAN
from amphion_tpu.ops.mel import MelConfig as JMelConfig
from amphion_tpu.ops import pallas_kernels as pk
from amphion_tpu.ops.mel import mel_spectrogram_xla
from amphion_tpu_torch.bins.vocoder import inference
from amphion_tpu_torch.data.audio_io import load_wav, save_wav
from amphion_tpu_torch.data.metadata import Utterance, save_metadata
from amphion_tpu_torch.models.vocoders.bigvgan import BigVGANConfig, BigVGANGenerator
from amphion_tpu_torch.modules.activations import SnakeBeta
from amphion_tpu_torch.modules.weight_norm import WNConv1d, WNConvTranspose1d
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.runtime.vocoder_trainer import (
    build_generator,
    load_vocoder,
    restore_generator,
    save_generator,
)
from amphion_tpu_torch.utils.config import load_config
from amphion_tpu_torch.utils.convert import from_flax, init_like_flax

ROOT = Path(__file__).resolve().parents[1]
EGS = ROOT / "egs/vocoder/gan/bigvgan/exp_config.json"
TINY = dict(upsample_rates=(5, 3), upsample_kernel_sizes=(10, 6), upsample_initial_channel=16,
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
SR = 24000
FRAMES = 30  # mel frames of every tiny-generator input: one compiled JAX shape


def _fill(shapes, seed: int):
    """Random leaves for a Flax parameter tree of ``jax.ShapeDtypeStruct``s:
    kernels normal, biases small, weight-norm scales around 1, log-scale
    Snake parameters near 0."""
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

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=3)
def _tiny(pallas: bool, activation: str = "snakebeta"):
    """(Flax tree, jitted JAX apply, port generator) of the tiny generator
    with ``use_pallas_act=pallas`` and ``activation``, built once per test
    process."""
    if pallas:
        pk._aa_polyphase_taps()  # probe the taps eagerly, not inside the trace
    kw = dict(TINY, use_pallas_act=pallas, activation=activation)
    jgen = JBigVGAN(JBigVGANConfig(**kw))
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 80)))["params"]
    tree = jax.tree_util.tree_map(np.asarray, _fill(shapes, seed=1))
    apply = jax.jit(lambda m: jgen.apply({"params": tree}, m))
    port = BigVGANGenerator(BigVGANConfig(**kw)).eval()
    return tree, apply, from_flax(port, tree)


@pytest.mark.parametrize("pallas,activation", [(True, "snakebeta"), (False, "snakebeta"),
                                               (True, "snake")],
                         ids=["fused", "chain", "snake_fused"])
def test_bigvgan_matches_jax(pallas, activation):
    """The tiny generator against JAX's, with the fused anti-aliased
    activation (JAX's Pallas kernel in interpret mode, the port's plain
    version) or the unfused chain; SnakeBeta, and Snake (``activation:
    "snake"``) fused."""
    _, apply, port = _tiny(pallas, activation)
    mel = np.random.default_rng(2).standard_normal((2, FRAMES, 80)).astype(np.float32)
    ref = np.asarray(apply(jnp.asarray(mel)))
    with torch.no_grad():
        out = port(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (2, FRAMES * 15)
    assert np.mean(np.abs(ref) > 0.99) < 0.05  # not saturated by the tanh
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_from_flax_consumes_every_leaf():
    tree, _, port = _tiny(False)
    leaves = jax.tree_util.tree_leaves(tree)
    params = list(port.parameters())
    assert len(leaves) == len(params)  # each parameter read a leaf of its own
    assert sum(x.size for x in leaves) == sum(p.numel() for p in params)


def test_from_flax_without_a_weight_norm_scale_raises():
    tree, _, port = _tiny(False)
    tree = jax.tree_util.tree_map(np.copy, tree)
    del tree["amp_1_3"]["WeightNorm_2"]["Conv_2/kernel/scale"]
    with pytest.raises(KeyError, match="Conv_2/kernel/scale"):
        from_flax(port, tree)


class _JWN(fnn.Module):
    """Flax WeightNorm around BigVGAN's ConvTranspose or dilated Conv."""

    ch: int
    k: int
    r: int  # stride of the ConvTranspose; 0 for a Conv
    d: int = 1

    @fnn.compact
    def __call__(self, x):
        if self.r:
            p = (self.k - self.r) // 2
            conv = fnn.ConvTranspose(self.ch, (self.k,), strides=(self.r,),
                                     padding=((self.k - 1 - p, self.k - 1 - (self.k - self.r - p)),))
        else:
            conv = fnn.Conv(self.ch, (self.k,), kernel_dilation=(self.d,), padding="SAME")
        return fnn.WeightNorm(conv)(x)


WN_CASES = [(10, 5, 1), (8, 4, 1), (6, 3, 1), (4, 2, 1), (11, 0, 5), (7, 0, 1)]
WN_CIN, WN_COUT, WN_T = 6, 5, 13


class _JWNAll(fnn.Module):
    """Every case of `WN_CASES`, one child each, so that one jitted apply
    serves them all."""

    @fnn.compact
    def __call__(self, xs):
        return [_JWN(WN_COUT, k, r, d, name=f"case_{i}")(x)
                for i, ((k, r, d), x) in enumerate(zip(WN_CASES, xs))]


@functools.lru_cache(maxsize=1)
def _wn_flax():
    """(Flax tree, inputs, outputs) of every weight-norm case, from one
    jitted apply."""
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((2, WN_T, WN_CIN)).astype(np.float32) for _ in WN_CASES]
    jm = _JWNAll()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            [jnp.zeros((1, WN_T, WN_CIN))] * len(WN_CASES))["params"]
    tree = jax.tree_util.tree_map(np.asarray, _fill(shapes, seed=6))
    refs = jax.jit(lambda xs: jm.apply({"params": tree}, xs))([jnp.asarray(x) for x in xs])
    return tree, xs, [np.asarray(r) for r in refs]


@pytest.mark.parametrize("case", range(len(WN_CASES)),
                         ids=[f"{k}-{r}-{d}" for k, r, d in WN_CASES])
def test_weight_norm_convs_match_flax(case):
    k, r, d = WN_CASES[case]
    tree, xs, refs = _wn_flax()
    holder = nn.Module()
    if r:
        holder.ConvTranspose_0 = WNConvTranspose1d(WN_CIN, WN_COUT, k, r)
    else:
        holder.Conv_0 = WNConv1d(WN_CIN, WN_COUT, k, d)
    from_flax(holder, tree[f"case_{case}"])
    with torch.no_grad():
        out = next(holder.children())(torch.from_numpy(xs[case])).numpy()
    assert out.shape == refs[case].shape == (2, WN_T * (r or 1), WN_COUT)
    np.testing.assert_allclose(out, refs[case], rtol=0, atol=1e-5)


def test_init_like_flax_follows_flax_fan_in():
    """The egs generator's first two upsampling stages at an eighth of its
    width, one AMP block each: every weight-normalised kernel drawn with
    Flax's fan-in (the product of the Flax kernel's shape but its last
    axis, so in·k for the ConvTranspose too), biases 0, scales 1, log-scale
    SnakeBeta α and β 0."""
    cfg = dataclasses.replace(build_generator(load_config(EGS), 80)[0].cfg,
                              upsample_rates=(5, 4), upsample_kernel_sizes=(10, 8),
                              upsample_initial_channel=64, resblock_kernel_sizes=(7,),
                              resblock_dilation_sizes=((1, 3),))
    shapes = jax.eval_shape(JBigVGAN(JBigVGANConfig(**{**cfg.__dict__, "use_pallas_act": False})).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 4, 80)))["params"]
    gen = init_like_flax(BigVGANGenerator(cfg), torch.Generator().manual_seed(0))
    sized = set()  # kinds whose std was held to Flax's fan-in
    for name, mod in gen.named_modules():
        if isinstance(mod, (WNConv1d, WNConvTranspose1d)):
            node = shapes
            for key in name.split("."):
                node = node[key]
            fan_in = int(np.prod(node["kernel"].shape[:-1]))
            std = mod.weight.detach().std().item() * fan_in ** 0.5
            if mod.weight.numel() >= 10000:
                assert abs(std - 1.0) < 0.05, (name, std)
                sized.add(type(mod))
            assert torch.all(mod.bias == 0) and torch.all(mod.scale == 1)
        elif isinstance(mod, SnakeBeta):
            assert torch.all(mod.alpha == 0) and torch.all(mod.beta == 0)
    assert sized == {WNConv1d, WNConvTranspose1d}


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The tiny fused generator as a port checkpoint, two wavs of FRAMES
    frames, their mels as .npy features, a config (the egs BigVGAN config
    with the tiny widths) and JAX's waveforms for them."""
    root = tmp_path_factory.mktemp("vocoder")
    tree, apply, port = _tiny(True)
    ckpt = save_generator(root / "ckpt", port, epoch=3, step=42)
    cfg = root / "tiny.json"
    cfg.write_text('{"base_config": "%s", "model": {"bigvgan": {"upsample_rates": [5, 3], '
                   '"upsample_kernel_sizes": [10, 6], "upsample_initial_channel": 16, '
                   '"resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]]}}}' % EGS)
    rng = np.random.default_rng(4)
    t = np.arange(FRAMES * 120) / SR
    (root / "feat").mkdir()
    ys = []
    for i in range(2):
        x = 0.3 * np.sin(2 * np.pi * (150 + 50 * i) * t) + 0.02 * rng.standard_normal(t.shape)
        save_wav(root / "wav" / f"u{i}.wav", x, SR)
        ys.append(load_wav(root / "wav" / f"u{i}.wav")[0])
    mels = mel_spectrogram_xla(jnp.asarray(np.stack(ys)), JMelConfig())  # (2, 80, FRAMES)
    wavs = np.asarray(apply(mels.transpose(0, 2, 1)))
    refs = {}
    for i in range(2):
        np.save(root / "feat" / f"u{i}.npy", np.asarray(mels[i]))
        refs[f"u{i}"] = wavs[i]
    return root, ckpt, cfg, refs


@pytest.mark.filterwarnings("ignore:.*found in sys.modules:RuntimeWarning")
def test_vocoder_cli_from_audio_matches_jax(cli_run, monkeypatch):
    root, ckpt, cfg, refs = cli_run
    out = root / "out_audio"
    # as `python -m amphion_tpu_torch.bins.vocoder.inference ...` runs it, in
    # this process (a fresh interpreter would spend seconds importing)
    argv = ["inference", "--config", str(cfg), "--checkpoint_path", str(Path(ckpt).parent),
            "--output_dir", str(out), "--mode", "from_audio",
            "--audio_dir", str(root / "wav"), "--device", "cpu"]
    monkeypatch.setattr(sys, "argv", argv)
    runpy.run_module("amphion_tpu_torch.bins.vocoder.inference", run_name="__main__")
    for uid, ref in refs.items():
        wav, sr = load_wav(out / f"{uid}.wav")
        assert sr == SR and wav.shape == ref.shape
        np.testing.assert_allclose(wav, ref, rtol=0, atol=1e-4)


def test_vocoder_cli_from_feature_matches_jax(cli_run):
    root, ckpt, cfg, refs = cli_run
    out = root / "out_feature"
    records = inference.main(["--config", str(cfg), "--checkpoint_path", ckpt,
                              "--output_dir", str(out), "--mode", "from_feature",
                              "--feature_dir", str(root / "feat"), "--device", "cpu"])
    assert [Path(r["path"]).name for r in records] == ["u0.wav", "u1.wav"]
    for uid, ref in refs.items():
        wav, _ = load_wav(out / f"{uid}.wav")
        np.testing.assert_allclose(wav, ref, rtol=0, atol=1e-4)
    fn, hop = load_vocoder(ckpt, 80, str(cfg), device="cpu")
    mel = np.load(root / "feat" / "u0.npy").T[None]
    assert hop == 15
    np.testing.assert_allclose(fn(torch.from_numpy(mel))[0].numpy(), refs["u0"], rtol=0,
                               atol=1e-5)


def test_vocoder_cli_from_dataset_matches_jax(cli_run):
    root, ckpt, cfg, refs = cli_run
    utts = [Utterance("tiny", uid, str(root / "wav" / f"{uid}.wav"), FRAMES * 120 / SR)
            for uid in refs]
    save_metadata(root / "data" / "tiny" / "test.json", utts)
    ds_cfg = root / "dataset.json"
    ds_cfg.write_text('{"base_config": "%s", "dataset": ["tiny"], '
                      '"preprocess": {"processed_dir": "%s"}}' % (cfg, root / "data"))
    out = root / "out_dataset"
    inference.main(["--config", str(ds_cfg), "--checkpoint_path", ckpt, "--output_dir",
                    str(out), "--mode", "from_dataset", "--device", "cpu"])
    for uid, ref in refs.items():
        np.testing.assert_allclose(load_wav(out / f"{uid}.wav")[0], ref, rtol=0, atol=1e-4)


def test_entry_points_raise_without_a_card(cli_run, monkeypatch):
    root, ckpt, cfg, _ = cli_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.main(["--config", str(cfg), "--checkpoint_path", ckpt, "--output_dir",
                        str(root / "never"), "--mode", "from_audio",
                        "--audio_dir", str(root / "wav")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_vocoder(ckpt, 80, str(cfg))
    assert not (root / "never").exists()


def test_restore_generator_takes_only_the_vocoder_layout(cli_run):
    """A checkpoint without the ``{"g": ...}`` entry is refused, not read
    in some other layout."""
    root, ckpt, cfg, _ = cli_run
    port = _tiny(True)[2]

    class Flat:
        def state_dict(self):
            return {"model": port.state_dict()}

    flat = CheckpointManager(root / "flat").save(Flat(), 0, 0, 0.0)
    with pytest.raises(KeyError, match="no 'g' entry"):
        restore_generator(load_config(cfg), flat, 80, torch.device("cpu"))
    gen, hop, epoch, step = restore_generator(load_config(cfg), ckpt, 80, torch.device("cpu"))
    assert (hop, epoch, step) == (15, 3, 42)


def test_other_generators_are_not_ported():
    """Every generator JAX's factory builds is ported (config/vocoder.json's
    default, HiFi-GAN, among them); a generator JAX does not know raises,
    as JAX's factory does."""
    cfg = load_config(ROOT / "config/vocoder.json")
    gen, hop = build_generator(cfg, 80)
    assert (type(gen).__name__, hop) == ("HiFiGANGenerator", 120)
    cfg["model"]["generator"] = "wavenet"
    with pytest.raises(ValueError, match="unknown generator 'wavenet'"):
        build_generator(cfg, 80)
