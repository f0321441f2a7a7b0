"""PyTorch port, the single-request TTS path on the CPU: the ragged MaskGCT
samplers on a batch of one against JAX's fixed-shape samplers, and
`MaskGCTPipeline.__call__` against the JAX package, then
`bins/tts/inference.py` in its VALLE and MaskGCT modes.

Tiny MaskGCT models (T2S and S2A 1 layer of width 32, a mel-proxy S2A:
``sem_proj``, no ``cond_emb``), a tiny semantic codec and Amphion codec;
Flax trees from ``jax.eval_shape`` filled from a numpy seed and carried over
by `utils/convert.from_flax`. JAX's pipeline runs with its samplers in
float32 (its pipeline passes no dtype: bf16 by default), and the port is
given the Gumbel draws JAX's samplers make from ``jax.random.key(0)``, in
their order, so tokens are held exactly: the samplers on the inputs JAX's
pipeline gave its `t2s_sample` and `s2a_sample`, then the whole
`__call__` (waveform within 1e-4). The CLI runs in process (`runpy`) on
port checkpoints written to a temporary directory, each mode writing a wav
of the length its own code gives.
"""

import copy
import functools
import json
import runpy
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.models.codec.amphion_codec import AmphionCodec as JCodec
from amphion_tpu.models.codec.amphion_codec import CodecConfig as JCodecConfig
from amphion_tpu.models.codec.repcodec import RepCodec as JRepCodec
from amphion_tpu.models.codec.repcodec import RepCodecConfig as JRepCodecConfig
from amphion_tpu.models.tts.maskgct import maskgct as jmaskgct
from amphion_tpu.pipelines import maskgct_pipeline as jpipeline
from amphion_tpu.text.symbol_table import SymbolTable as JSymbolTable
from amphion_tpu_torch.data.audio_io import load_wav, save_wav
from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec, CodecConfig
from amphion_tpu_torch.models.codec.repcodec import RepCodec, RepCodecConfig
from amphion_tpu_torch.models.tts.maskgct.maskgct import (
    MaskGCTS2A,
    MaskGCTT2S,
    S2AConfig,
    T2SConfig,
)
from amphion_tpu_torch.models.tts.maskgct.ragged_sampling import (
    s2a_sample_ragged,
    t2s_sample_ragged,
)
from amphion_tpu_torch.models.tts.valle.valle import (
    VALLE,
    VALLEConfig,
    ar_generate,
    prepare_for_decode,
)
from amphion_tpu_torch.pipelines.maskgct_pipeline import MaskGCTPipeline
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.text.g2p import G2PModule
from amphion_tpu_torch.text.symbol_table import SymbolTable
from amphion_tpu_torch.utils.convert import from_flax, init_like_flax

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SR = 8000
# one vocabulary width (24) for the semantic and the acoustic codes: JAX's
# draws of both samplers come from one compiled program
T2S = dict(hidden=32, num_layers=1, num_heads=4, codebook_size=24, phone_vocab=64)
S2A = dict(hidden=32, num_layers=1, num_heads=4, codebook_size=24, num_quantizers=2,
           semantic_dim=24)
SEM = dict(feature_dim=8, hidden=24, codebook_size=24, codebook_dim=4, num_blocks=1)
CODEC = dict(sample_rate=SR, strides=(2, 4), num_quantizers=2, codebook_size=24,
             codebook_dim=4, encoder_dim=4, latent_dim=8, decoder_dim=4)
PROMPT, TARGET = "hello you", "a quick test"


def fill(shapes, seed: int):
    """Random leaves for a Flax tree: kernels normal over √fan_in, biases
    small, norm and weight-norm scales and Snake α in [0.5, 1.5], the rest
    normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("scale", "alpha") or name.endswith("/scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _features(audio: np.ndarray) -> np.ndarray:
    """A stand-in semantic extractor: 4 samples a frame (twice the codec's
    rate, as the served mel front end runs) through a fixed projection."""
    n = max(len(audio) // 4, 1)
    frames = np.pad(audio, (0, 4 * n - len(audio)))[: 4 * n].reshape(n, 4)
    proj = np.random.default_rng(99).standard_normal((4, 8)).astype(np.float32)
    return np.tanh(frames @ proj * 3.0).astype(np.float32)


def _audio(seconds: float, seed: int) -> np.ndarray:
    t = np.arange(int(SR * seconds)) / SR
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * (150 + 40 * seed) * t)
            + 0.03 * rng.standard_normal(t.shape)).astype(np.float32)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _step_draws(key, t, v):
    """One fixed-shape mask-predict step's draws as JAX's samplers split and
    draw them: the (1, t, v) sampling noise, then the (1, t) re-mask noise."""
    key, a, b = jax.random.split(key, 3)
    return key, jmaskgct._gumbel(a, (1, t, v)), jmaskgct._gumbel(b, (1, t))


def _draws(key, n_steps: int, t: int, v: int) -> list:
    out = []
    for _ in range(n_steps):
        key, a, b = _step_draws(key, t, v)
        out += [np.asarray(a), np.asarray(b)]
    return out


def jax_draws(t_len: int) -> tuple[list, list]:
    """(T2S, S2A) draws of JAX's `MaskGCTPipeline.__call__` with key 0: the
    T2S's 25 steps from the first split, the S2A's layers (16 steps, then
    1) each from a key split off before it."""
    r1, r2 = jax.random.split(jax.random.key(0))
    s2a = []
    for q in range(S2A["num_quantizers"]):
        r2, r = jax.random.split(r2)
        s2a += _draws(r, 16 if q == 0 else 1, t_len, S2A["codebook_size"])
    return _draws(r1, 25, t_len, T2S["codebook_size"]), s2a


class JitPipeline(jpipeline.MaskGCTPipeline):
    """JAX's pipeline with its codec calls jitted (eager Flax dispatches op
    by op), as a served front end would run them."""

    def _jit(self, name, method):
        key = f"_jit_{name}_{method}"
        if key not in self.__dict__:
            mod = getattr(self, name)
            self.__dict__[key] = jax.jit(lambda p, *a: mod.apply(
                {"params": p}, *a, method=getattr(type(mod), method)))
        return functools.partial(self.__dict__[key], self.params[name])

    def extract_semantic_code(self, audio):
        feats = jnp.asarray(self.semantic_extractor(audio, self.sample_rate))[None]
        return self._jit("semantic_codec", "encode")(feats)

    def extract_acoustic_code(self, audio):
        return self._jit("acoustic_codec", "encode")(jnp.asarray(audio)[None])

    def codec_decode(self, codes):
        return np.asarray(self._jit("acoustic_codec", "decode_codes")(
            jnp.transpose(codes, (1, 0, 2))))[0]


@pytest.fixture(scope="module")
def pipes():
    """JAX's pipeline run once on a prompt (its samplers' inputs and outputs
    recorded), and the port's pipeline of the same weights."""
    jt, js = jmaskgct.MaskGCTT2S(jmaskgct.T2SConfig(**T2S)), jmaskgct.MaskGCTS2A(
        jmaskgct.S2AConfig(**S2A))
    jsem, jac = JRepCodec(JRepCodecConfig(**SEM)), JCodec(JCodecConfig(**CODEC))
    shape = jax.eval_shape
    trees = {
        "t2s": shape(functools.partial(jt.init, method=jt.compute_loss), jax.random.key(0),
                     jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8)),
                     jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4)), jax.random.key(1)),
        "s2a": shape(functools.partial(js.init, method=js.compute_loss), jax.random.key(0),
                     jnp.zeros((1, 2, 8), jnp.int32), jnp.ones((1, 8)), jnp.zeros((1, 8, 24)),
                     jax.random.key(1)),
        "semantic_codec": shape(jsem.init, jax.random.key(0), jnp.zeros((1, 8, 8))),
        "acoustic_codec": shape(jac.init, jax.random.key(0), jnp.zeros((1, 32))),
    }
    trees = {k: fill(v["params"], 20 + i) for i, (k, v) in enumerate(trees.items())}
    symbols = ["_"] + sorted(set(PROMPT + TARGET))
    jpipe = JitPipeline(
        t2s=jt, s2a=js, semantic_codec=jsem, acoustic_codec=jac, params=trees,
        semantic_extractor=lambda a, sr: _features(a),
        symbol_table=JSymbolTable.from_symbols(symbols), sample_rate=SR)
    calls = {}

    def recording(name, fn):
        def run(*a, **kw):
            out = fn(*a, **kw, compute_dtype="float32")
            calls[name] = (a, kw, np.asarray(out))
            return out
        return run
    audio = _audio(0.05, 1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jpipeline, "t2s_sample", recording("t2s", jmaskgct.t2s_sample))
    mp.setattr(jpipeline, "s2a_sample", recording("s2a", jmaskgct.s2a_sample))
    try:
        want = jpipe(audio, PROMPT, TARGET, jax.random.key(0))
    finally:
        mp.undo()
    port = MaskGCTPipeline(
        t2s=from_flax(MaskGCTT2S(T2SConfig(**T2S)), trees["t2s"]).eval(),
        s2a=from_flax(MaskGCTS2A(S2AConfig(**S2A), False, True), trees["s2a"]).eval(),
        semantic_codec=from_flax(RepCodec(RepCodecConfig(**SEM), with_decode=True),
                                 trees["semantic_codec"]).eval(),
        acoustic_codec=from_flax(AmphionCodec(CodecConfig(**CODEC)),
                                 trees["acoustic_codec"]).eval(),
        semantic_extractor=lambda a: torch.from_numpy(_features(a.numpy())),
        symbol_table=SymbolTable.from_symbols(symbols), sample_rate=SR, compute_dtype="float32")
    return audio, want, calls, port, jax_draws(calls["t2s"][2].shape[1])


def test_fixed_shape_samplers_match_jax(pipes):
    """JAX's fixed-shape `t2s_sample` (CFG 2.5, 25 steps) and `s2a_sample`
    (16 + 1 steps, on the semantic codec's latents) against the port's
    ragged samplers on a batch of one (what `MaskGCTPipeline.__call__`
    runs), on the inputs JAX's pipeline gave its own, with its draws:
    tokens equal."""
    _, _, calls, port, (d_t2s, d_s2a) = pipes

    def n(length):
        return torch.tensor([length])
    (_, _, prompt, phones, target_len, _), kw, want = calls["t2s"]
    prompt, phones = (torch.from_numpy(np.array(x)).long() for x in (prompt, phones))
    got = t2s_sample_ragged(port.t2s, prompt, n(prompt.shape[1]), phones, n(phones.shape[1]),
                            n(target_len), [None], target_len, n_steps=25, cfg=kw["cfg"],
                            compute_dtype="float32", gumbel=iter(d_t2s))
    assert kw["cfg"] == 2.5 and kw["schedule"] == "sin"
    assert got.shape == want.shape == (1, target_len)
    np.testing.assert_array_equal(got.numpy(), want)
    (_, _, sem, prompt_ac, target_len, _), kw, want = calls["s2a"]
    prompt_ac = torch.from_numpy(np.array(prompt_ac)).long()
    got = s2a_sample_ragged(port.s2a, torch.from_numpy(np.array(sem)), prompt_ac,
                            n(prompt_ac.shape[2]), n(target_len), [None], target_len,
                            first_layer_steps=kw["first_layer_steps"], compute_dtype="float32",
                            gumbel=iter(d_s2a))
    assert got.shape == want.shape == (1, S2A["num_quantizers"], target_len)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="injected"):
        t2s_sample_ragged(port.t2s, torch.zeros((1, 3), dtype=torch.long), n(3),
                          torch.ones((1, 4), dtype=torch.long), n(4), n(5), [None], 5,
                          n_steps=2, compute_dtype="float32", gumbel=iter(d_t2s))


def test_pipeline_call_matches_jax(pipes):
    """`MaskGCTPipeline.__call__`: the proportional target length, the same
    tokens into the codec and the waveform within 1e-4 of JAX's; without
    injected draws two seeds give two waveforms."""
    audio, want, calls, port, draws = pipes
    seen = []
    real = port.semantic2acoustic

    def keep(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]
    port.semantic2acoustic = keep
    try:
        got = port(audio, PROMPT, TARGET, gumbel=tuple(iter(d) for d in draws))
    finally:
        del port.semantic2acoustic
    np.testing.assert_array_equal(seen[0].numpy(), calls["s2a"][2])
    t_len = int(len(audio) // 4 * len(TARGET) / len(PROMPT)) + 1
    assert calls["t2s"][0][4] == t_len and got.shape == want.shape == (t_len * 8,)
    np.testing.assert_allclose(got, want, atol=1e-4)
    a, b = (port(audio, PROMPT, TARGET, seed=s) for s in (3, 4))
    assert a.shape == got.shape and not np.array_equal(a, b) and np.isfinite(a).all()


def _save(module_state: dict, where: Path) -> None:
    state = types.SimpleNamespace(state_dict=lambda: {"model": module_state})
    CheckpointManager(where).save(state, 1, 10, 0.0)


def _run_cli(argv: list[str]) -> None:
    old = sys.argv
    sys.argv = ["inference.py", *argv]
    try:
        runpy.run_module("amphion_tpu_torch.bins.tts.inference", run_name="__main__")
    finally:
        sys.argv = old


VALLE_TINY = dict(audio_vocab=24, num_quantizers=2, hidden=32, num_layers=1, num_heads=4,
                  max_position=512)


def test_cli_valle_mode(tmp_path):
    """`model_type` VALLE from a port checkpoint, greedy (top-k 1): a wav of
    the frames the AR (bf16) generates from the prompt's codes."""
    codec_cfg = {k: v for k, v in CODEC.items() if k != "sample_rate"}
    cfg = {"base_config": str(REPO / "egs/tts/VALLE/exp_config.json"), "dataset": ["tiny"],
           "log_dir": str(tmp_path / "ckpts"),
           "preprocess": {"sample_rate": SR, "processed_dir": str(tmp_path / "processed")},
           "model": {"valle": VALLE_TINY, "codec": codec_cfg}}
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    symbols = SymbolTable.from_symbols(["_"] + sorted(set(PROMPT + " " + TARGET)))
    symbols.to_file(tmp_path / "processed" / "tiny" / "symbols.dict")
    g = torch.Generator().manual_seed(5)
    model = init_like_flax(VALLE(VALLEConfig(num_phones=64, **VALLE_TINY)), g).eval()
    _save(model.state_dict(), tmp_path / "ckpts" / "valle" / "checkpoint")
    codec = init_like_flax(AmphionCodec(CodecConfig(**CODEC)), g).eval()
    _save(codec.state_dict(), tmp_path / "codec")
    save_wav(tmp_path / "prompt.wav", _audio(0.1, 2), SR)
    _run_cli(["--config", str(tmp_path / "tiny.json"), "--exp_name", "valle",
              "--codec_ckpt", str(tmp_path / "codec"), "--prompt_audio",
              str(tmp_path / "prompt.wav"), "--prompt_text", PROMPT, "--text", TARGET,
              "--output_path", str(tmp_path / "out.wav"), "--max_new", "12", "--top_k", "1",
              "--device", "cpu"])
    wav, sr = load_wav(tmp_path / "out.wav")
    prompt, _ = load_wav(tmp_path / "prompt.wav")
    codes = codec.encode(torch.from_numpy(prompt)[None])[:, 0]
    ids = G2PModule("char").to_ids(PROMPT + " " + TARGET, symbols)
    _, n = ar_generate(prepare_for_decode(copy.deepcopy(model), "bfloat16"),
                       torch.tensor([ids]), codes[0][None], torch.Generator(), max_new=12,
                       top_k=1, compute_dtype="bfloat16")
    assert sr == SR and len(wav) == max(int(n[0]), 1) * 8 and np.abs(wav).max() > 0


def test_cli_maskgct_mode(tmp_path):
    """`model_type` MaskGCT through `build_maskgct_pipeline` (the mel front
    end, bf16): the wav holds the PCM16 of `MaskGCTPipeline.__call__` at
    seed 0."""
    from amphion_tpu_torch.bins.tts.inference import build_maskgct_pipeline, parse_args
    from amphion_tpu_torch.utils.config import load_config

    model = {"t2s": {k: v for k, v in T2S.items() if k != "phone_vocab"},
             "s2a": {k: v for k, v in S2A.items() if k not in ("num_quantizers", "semantic_dim")},
             "semantic_codec": {k: v for k, v in SEM.items() if k != "feature_dim"},
             "codec": {k: v for k, v in CODEC.items() if k != "sample_rate"}}
    cfg = {"base_config": str(REPO / "egs/tts/MaskGCT/exp_config.json"), "dataset": ["tiny"],
           "log_dir": str(tmp_path / "ckpts"), "model": model,
           # the semantic frames at twice the codec's rate, as served
           "preprocess": {"sample_rate": SR, "n_fft": 32, "win_size": 32, "hop_size": 4,
                          "n_mel": 8, "fmax": 4000,
                          "processed_dir": str(tmp_path / "processed")}}
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    SymbolTable.from_symbols(["_"] + sorted(set(PROMPT + TARGET))).to_file(
        tmp_path / "processed" / "tiny" / "symbols.dict")
    g = torch.Generator().manual_seed(6)
    t2s = init_like_flax(MaskGCTT2S(T2SConfig(**T2S)), g)
    s2a = init_like_flax(MaskGCTS2A(S2AConfig(**S2A), False, True), g)
    _save({**{f"t2s.{k}": v for k, v in t2s.state_dict().items()},
           **{f"s2a.{k}": v for k, v in s2a.state_dict().items()}},
          tmp_path / "ckpts" / "maskgct" / "checkpoint")
    save_wav(tmp_path / "prompt.wav", _audio(0.1, 3), SR)
    argv = ["--config", str(tmp_path / "tiny.json"), "--exp_name", "maskgct",
            "--prompt_audio", str(tmp_path / "prompt.wav"), "--prompt_text", PROMPT,
            "--text", TARGET, "--output_path", str(tmp_path / "out.wav"), "--device", "cpu"]
    _run_cli(argv)
    wav, sr = load_wav(tmp_path / "out.wav")
    args = parse_args(argv)
    pipe = build_maskgct_pipeline(args, load_config(args.config), types.SimpleNamespace(
        info=lambda *a: None, warning=lambda *a: None), device="cpu")
    prompt, _ = load_wav(tmp_path / "prompt.wav")
    want = pipe(prompt, PROMPT, TARGET, seed=0)
    pcm = (np.clip(want, -1.0, 1.0) * 32767.0).astype(np.int16).astype(np.float32) / 32768.0
    assert sr == SR and len(wav) % 8 == 0 and np.abs(wav).max() > 0
    np.testing.assert_array_equal(wav, pcm)
    with pytest.raises(NotImplementedError, match="A6"):
        _run_cli(["--config", str(REPO / "egs/tts/Jets/exp_config.json"), "--text", "hi",
                  "--output_path", str(tmp_path / "jets.wav"), "--device", "cpu"])

