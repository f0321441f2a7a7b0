"""PyTorch port, MaskGCT's codecs, service and serve CLI on the CPU: the
residual VQ (factorized and plain), the Amphion codec's encode (codes
exact) and its length-masked ragged decode, and `RepCodec.decode_tokens`
against the JAX package (Flax trees from ``jax.eval_shape`` filled from a
numpy seed, every JAX side jitted); then, port only, `MaskGCTService`'s
batch-of-one against batch-of-three and `bins/serve.py --backend maskgct`
from port checkpoints under a temporary ``log_dir``, driven by
`serving/loadgen.py`. The codec runs the odd stride 5, whose transposed
convolution pads asymmetrically. Tolerances (float32): quantized latents
and waveforms 1e-4 absolute, codes exact.
"""

import base64
import io
import json
import logging
import threading
import types
import urllib.request
import wave
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
from amphion_tpu.modules.quantize import ResidualVQ as JResidualVQ
from amphion_tpu_torch.bins import serve as serve_cli
from amphion_tpu_torch.bins.tts.inference import build_maskgct_pipeline
from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec, CodecConfig
from amphion_tpu_torch.models.codec.repcodec import RepCodec, RepCodecConfig
from amphion_tpu_torch.models.tts.maskgct.maskgct import (
    MaskGCTS2A,
    MaskGCTT2S,
    S2AConfig,
    T2SConfig,
)
from amphion_tpu_torch.modules.quantize import ResidualVQ
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.serving import loadgen
from amphion_tpu_torch.serving.service import MaskGCTService
from amphion_tpu_torch.text.symbol_table import SymbolTable
from amphion_tpu_torch.utils.config import load_config
from amphion_tpu_torch.utils.convert import from_flax, init_like_flax

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CODEC = dict(sample_rate=8000, encoder_dim=4, latent_dim=8, decoder_dim=4, strides=(2, 5),
             num_quantizers=3, codebook_size=16, codebook_dim=4)
HOP = 10


def fill(shapes, seed: int):
    """Random leaves for a Flax tree of ``jax.ShapeDtypeStruct``s: kernels
    normal over √fan_in, codebooks normal, biases small, weight-norm scales
    and Snake α in [0.5, 1.5]."""
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


def F32(a):
    return torch.from_numpy(np.array(a, np.float32))


# -- quantizers and codecs against JAX ----------------------------------------------------


@pytest.mark.parametrize("kind", ["fvq", "vq"])
def test_residual_vq_matches_jax(kind):
    jm = JResidualVQ(num_quantizers=3, codebook_size=16, codebook_dim=4, input_dim=8,
                     quantizer_type=kind)
    x = np.random.default_rng(1).standard_normal((2, 12, 8)).astype(np.float32)
    if kind == "vq":  # a plain VQ looks up codes of the input's width
        jm = jm.clone(codebook_dim=8)
    tree = fill(jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 4, 8)))["params"], 2)
    def quantize_and_decode(x):
        out, idx, _ = jm.apply({"params": tree}, x)
        return out, idx, jm.apply({"params": tree}, idx, method=JResidualVQ.decode)
    out, idx, dec = jax.jit(quantize_and_decode)(x)
    port = from_flax(ResidualVQ(3, 16, jm.codebook_dim, 8, kind), tree)
    with torch.no_grad():
        q, codes = port.quantize(F32(x))
        np.testing.assert_array_equal(codes.numpy(), np.asarray(idx))
        np.testing.assert_array_equal(port.encode(F32(x)).numpy(), np.asarray(idx))
        np.testing.assert_allclose(q.numpy(), np.asarray(out), atol=1e-5)
        np.testing.assert_allclose(port.decode(codes).numpy(), np.asarray(dec), atol=1e-5)


@pytest.fixture(scope="module")
def codec_pair():
    jm = JCodec(JCodecConfig(**CODEC))
    tree = fill(jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 4 * HOP)))["params"], 3)
    return jm, tree, from_flax(AmphionCodec(CodecConfig(**CODEC)), tree).eval()


def test_codec_encode_and_decode_match_jax(codec_pair):
    """Encode: codes equal JAX's. The decode with mixed ``frame_lengths``:
    each row within 1e-4 of JAX's, and its valid part equal to the row
    decoded alone (no pad bleed)."""
    jm, tree, port = codec_pair
    audio = (0.3 * np.random.default_rng(4).standard_normal((2, 37 * HOP))).astype(np.float32)
    codes = np.random.default_rng(5).integers(0, 16, (3, 3, 20))
    lens = np.array([20, 13, 7])
    want_codes, want = jax.jit(lambda a, c, f: (
        jm.apply({"params": tree}, a, method=JCodec.encode),
        jm.apply({"params": tree}, c, f, method=JCodec.decode_codes)))(audio, codes, lens)
    got_codes = port.encode(F32(audio))
    assert got_codes.shape == (3, 2, 37)
    np.testing.assert_array_equal(got_codes.numpy(), np.asarray(want_codes))
    got = port.decode_codes(torch.from_numpy(codes), torch.from_numpy(lens)).numpy()
    assert got.shape == (3, 20 * HOP) and np.abs(got).max() > 1e-2
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    for i, n in enumerate(lens):
        solo = port.decode_codes(torch.from_numpy(codes[:, i:i + 1, :n])).numpy()[0]
        np.testing.assert_allclose(got[i, : n * HOP], solo, atol=1e-4)


def test_repcodec_decode_tokens_matches_jax():
    cfg = dict(feature_dim=8, hidden=24, codebook_size=24, codebook_dim=4, num_blocks=1)
    jm = JRepCodec(JRepCodecConfig(**cfg))
    tree = fill(jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 6, 8)))["params"], 6)
    port = from_flax(RepCodec(RepCodecConfig(**cfg), with_decode=True), tree)
    feats = np.random.default_rng(7).standard_normal((2, 9, 8)).astype(np.float32)
    tokens = jax.jit(lambda f: jm.apply({"params": tree}, f, method=JRepCodec.encode))(feats)
    want = jax.jit(lambda t: jm.apply({"params": tree}, t, method=JRepCodec.decode_tokens))(
        tokens)
    np.testing.assert_array_equal(port.encode(F32(feats)).numpy(), np.asarray(tokens))
    got = port.decode_tokens(torch.from_numpy(np.array(tokens)).long())
    assert got.shape == (2, 9, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mel_band_tables_take_inference_tensors():
    """The MaskGCT front end runs the mel under ``torch.inference_mode``: the
    mel wrapper's band tables cache a filterbank made there (it has no
    version counter), and `_fbank` hands out a normal tensor whoever asks
    first."""
    from amphion_tpu_torch.ops.kernels.mel import _device_band_tables, band_tables
    from amphion_tpu_torch.ops.mel import MelConfig, _fbank

    with torch.inference_mode():
        fb = _fbank(MelConfig(fmax=7000.0), torch.device("cpu"))
        inf = fb.clone()
        bands, weights = _device_band_tables(inf)
    assert not fb.is_inference() and inf.is_inference()
    want = band_tables(fb.numpy())
    assert np.array_equal(bands.numpy(), want[0]) and np.array_equal(weights.numpy(), want[1])
    assert _device_band_tables(inf)[0] is bands  # cached


# -- the port's service and CLI -------------------------------------------------------------

SR = 8000
TINY_MODEL = {"t2s": {"hidden": 32, "num_layers": 1, "num_heads": 4, "codebook_size": 24},
              "s2a": {"hidden": 32, "num_layers": 1, "num_heads": 4, "codebook_size": 16},
              "codec": {"strides": [2, 4], "num_quantizers": 2, "codebook_size": 16,
                        "codebook_dim": 4, "encoder_dim": 4, "latent_dim": 8,
                        "decoder_dim": 4},
              "semantic_codec": {"codebook_size": 24, "hidden": 24, "codebook_dim": 4,
                                 "num_blocks": 1}}
TINY_PRE = {"sample_rate": SR, "n_fft": 64, "win_size": 64, "hop_size": 32, "n_mel": 8,
            "fmax": 4000}
TEXTS = ["hello there", "a quick test", "some more words"]


def _audio(seconds: float, seed: int) -> np.ndarray:
    t = np.arange(int(SR * seconds)) / SR
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * (150 + 40 * seed) * t)
            + 0.03 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny_cli(tmp_path_factory):
    """A tiny config over `egs/tts/MaskGCT/exp_config.json`, its symbol
    table, a T2S+S2A checkpoint (the mel-proxy S2A: ``sem_proj``, no
    ``cond_emb``) under ``log_dir/maskgct/checkpoint`` and a semantic-codec
    checkpoint, in the port's format; the acoustic codec is left random."""
    root = tmp_path_factory.mktemp("maskgct")
    cfg = {"base_config": str(REPO / "egs/tts/MaskGCT/exp_config.json"),
           "dataset": ["tiny"], "log_dir": str(root / "ckpts"),
           "preprocess": {**TINY_PRE, "processed_dir": str(root / "processed")},
           "model": TINY_MODEL}
    path = root / "tiny.json"
    path.write_text(json.dumps(cfg))
    symbols = SymbolTable.from_symbols(["_"] + sorted({c for t in TEXTS for c in t}))
    symbols.to_file(root / "processed" / "tiny" / "symbols.dict")
    g = torch.Generator().manual_seed(3)
    t2s = init_like_flax(MaskGCTT2S(T2SConfig(**TINY_MODEL["t2s"], phone_vocab=64)), g)
    s2a = init_like_flax(MaskGCTS2A(S2AConfig(**TINY_MODEL["s2a"], num_quantizers=2,
                                              semantic_dim=24), False, True), g)
    sem = init_like_flax(RepCodec(RepCodecConfig(**TINY_MODEL["semantic_codec"], feature_dim=8),
                                  with_decode=True), g)

    def save(model_state: dict, where: Path):
        state = types.SimpleNamespace(state_dict=lambda: {"model": model_state})
        CheckpointManager(where).save(state, 1, 10, 0.0)
    save({**{f"t2s.{k}": v for k, v in t2s.state_dict().items()},
          **{f"s2a.{k}": v for k, v in s2a.state_dict().items()}},
         root / "ckpts" / "maskgct" / "checkpoint")
    save(sem.state_dict(), root / "sem")
    return root, path


def _cli_args(tiny_cli, *extra):
    root, path = tiny_cli
    return serve_cli.parse_args(["--config", str(path), "--device", "cpu", "--port", "0",
                                 "--compute_dtype", "float32", "--semantic_ckpt",
                                 str(root / "sem"), "--max_wait_ms", "1",
                                 "--max_prompt_len", "32", *extra])


def test_service_batch_of_one_equals_batch(tiny_cli):
    """Each request alone (a batch of one) equals the same request served
    in a batch of three, bit for bit: tokens from each request's own
    generators, the decode length-masked. Run with oneDNN's convolutions
    off: oneDNN picks its algorithm by the batch size, which moves the
    codec's last bits (up to 4e-5 on these weights); the plain convolution
    computes each row alone."""
    args = _cli_args(tiny_cli)
    pipe = build_maskgct_pipeline(args, load_config(args.config), logging.getLogger("test"),
                                  device="cpu", compute_dtype="float32")
    assert not pipe.token_cond and pipe.semantic_rate == SR // 32
    kw = dict(len_step=16, t2s_kwargs={"n_steps": 3}, s2a_kwargs={"first_layer_steps": 2},
              audio_grid_s=0.02)
    # one bucket (len_step 16): prompts of 15 frames, 20-24 phones, 17-23 target frames
    reqs = [(_audio(0.05, i), "hello you", TEXTS[i], 17 + 3 * i, 30 + i) for i in range(3)]
    no_onednn = torch.backends.mkldnn.flags(enabled=False)
    no_onednn.__enter__()
    alone_svc = MaskGCTService(pipe, max_batch=3, max_wait_ms=1.0, **kw)
    try:
        alone = [alone_svc.synthesize(a, p, t, target_len=n, seed=s) for a, p, t, n, s in reqs]
    finally:
        alone_svc.shutdown()
    svc = MaskGCTService(pipe, max_batch=3, max_wait_ms=10000.0, **kw)
    out = {}

    def call(i):
        a, p, t, n, s = reqs[i]
        out[i] = svc.synthesize(a, p, t, target_len=n, seed=s)
    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
        assert svc.stats()["max_batch"] == 3
    finally:
        svc.shutdown()
        no_onednn.__exit__(None, None, None)
    for i, (_, _, _, n, _) in enumerate(reqs):
        assert out[i].shape == (n * 8,) and np.isfinite(out[i]).all()
        np.testing.assert_array_equal(out[i], alone[i])


def test_build_maskgct_pipeline_sources(tiny_cli, tmp_path):
    """A ``--weights_dir`` manifest of per-module port checkpoints restores
    the same modules as ``log_dir`` + ``--semantic_ckpt``; an Orbax
    directory raises."""
    root, path = tiny_cli
    cfg = load_config(path)
    log = logging.getLogger("test")
    args = _cli_args(tiny_cli)
    pipe = build_maskgct_pipeline(args, cfg, log, device="cpu", compute_dtype="float32")
    manifest = {}
    for name, mod in (("t2s", pipe.t2s), ("s2a_full", pipe.s2a),
                      ("semantic_codec", pipe.semantic_codec),
                      ("acoustic_codec", pipe.acoustic_codec)):
        state = types.SimpleNamespace(state_dict=lambda m=mod: {"model": m.state_dict()})
        manifest[name] = CheckpointManager(tmp_path / name).save(state, 1, 1, 0.0)
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    args2 = _cli_args(tiny_cli, "--weights_dir", str(tmp_path))
    pipe2 = build_maskgct_pipeline(args2, cfg, log, device="cpu", compute_dtype="float32")
    for name in ("t2s", "s2a", "semantic_codec", "acoustic_codec"):
        a, b = getattr(pipe, name).state_dict(), getattr(pipe2, name).state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    orbax = tmp_path / "orbax" / "epoch-0001_step-0000001_loss-0.000000"
    (orbax / "_CHECKPOINT_METADATA").parent.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="Orbax"):
        build_maskgct_pipeline(_cli_args(tiny_cli, "--codec_ckpt", str(orbax.parent)), cfg, log,
                               device="cpu")


def test_http_maskgct_round_trip(tiny_cli):
    """`bins/serve.py` as a user starts it (its default backend, maskgct):
    three requests under a fixed Poisson trace, each a well-formed wav of
    ``int(target_sec · semantic_rate)`` codec frames of 8 samples."""
    # the three share one bucket: the window closes when the third arrives
    args = _cli_args(tiny_cli, "--max_wait_ms", "500", "--max_batch", "3")
    assert args.backend == "maskgct" and args.batcher == "window"
    backend = serve_cli.BUILDERS[args.backend](args)
    httpd = serve_cli.serve(backend.synth, backend.stats, "maskgct", port=0,
                            input_sr=backend.sample_rate)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    secs = [0.05, 0.08, 0.06]
    replies = {}
    submit = loadgen.http_synthesize_submit(url, timeout_s=120)

    def make_request(i):
        wav = serve_cli._encode_wav_bytes(_audio(0.04 + 0.01 * i, i), SR)
        return {"prompt_wav": base64.b64encode(wav).decode(), "prompt_text": "hello",
                "target_text": TEXTS[i], "target_sec": secs[i], "seed": 50 + i}

    def keep(payload):
        replies[payload["seed"]] = submit(payload)
    try:
        res = loadgen.run_trace(keep, make_request, loadgen.poisson_arrivals(20.0, 3, seed=1),
                                drain_timeout_s=120)
        with urllib.request.urlopen(url + "/api/health", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(url + "/api/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
        backend.shutdown()
    assert res.n_ok == 3 and res.n_err == 0
    assert health["backend"] == "maskgct" and stats["completed"] == 3 and stats["max_batch"] >= 2
    for i, sec in enumerate(secs):
        with wave.open(io.BytesIO(replies[50 + i])) as w:
            assert (w.getframerate(), w.getnchannels(), w.getsampwidth()) == (SR, 1, 2)
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        assert len(pcm) == int(sec * (SR // 32)) * 8 and np.abs(pcm).max() > 0
