"""PyTorch port, VALL-E serving on the CPU: `VALLEService` and the
continuous engine against the JAX package, then the port's continuous
service and `bins/serve.py --backend valle`.

One tiny VALL-E (2 layers, width 64, 32 codes a codebook, 3 codebooks, the
EOS logit raised so that requests stop at different steps) and a tiny
Amphion codec (strides 2 and 5 at 8 kHz), Flax trees from
``jax.eval_shape`` filled from a numpy seed, carried over by
`utils/convert.from_flax`; the char G2P over a symbol table of the texts.

- The window `VALLEService` against JAX's at temperature 0 on one batch of
  three: codes equal, waveforms within 1e-4.
- `ContinuousValleBatcher` against JAX's engine, greedy: three requests
  through two slots, each one's tokens equal.
- `ValleContinuousService` against the port's window service with sampled
  requests on their own seeds: tokens (the engine's against the window
  batch's) equal, waveforms within 1e-4.
- `bins/serve.py --backend valle --device cpu` from port checkpoints under
  a temporary ``log_dir``, the continuous batcher by default: three
  requests under `serving/loadgen.py`, each a well-formed wav.
"""

import base64
import io
import json
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
from amphion_tpu.models.tts.valle import valle as jvalle
from amphion_tpu.serving import continuous as jcontinuous
from amphion_tpu.serving import service as jservice
from amphion_tpu.text.g2p import G2PModule as JG2P
from amphion_tpu.text.symbol_table import SymbolTable as JSymbolTable
from amphion_tpu.utils.tokenizer import AudioTokenizer as JTokenizer
from amphion_tpu_torch.bins import serve as serve_cli
from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec, CodecConfig
from amphion_tpu_torch.models.tts.valle.valle import VALLE, VALLEConfig
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.serving import loadgen
from amphion_tpu_torch.serving import service as service_mod
from amphion_tpu_torch.serving.continuous import ContinuousValleBatcher
from amphion_tpu_torch.serving.continuous_service import ValleContinuousService
from amphion_tpu_torch.serving.service import VALLEService
from amphion_tpu_torch.text.g2p import G2PModule
from amphion_tpu_torch.text.symbol_table import SymbolTable
from amphion_tpu_torch.utils.convert import from_flax
from amphion_tpu_torch.utils.tokenizer import AudioTokenizer

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SR = 8000
CODEC = dict(sample_rate=SR, encoder_dim=4, latent_dim=8, decoder_dim=4, strides=(2, 5),
             num_quantizers=3, codebook_size=32, codebook_dim=4)
HOP = 10
# 24, 19 and 29 phones: the batch's rows are told apart by their phone counts
TEXTS = [("hello there", "a quick test"), ("good day", "more words"),
         ("hi", "another long sentence here")]
CHARS = sorted({c for pair in TEXTS for t in pair for c in t})
VOCAB = dict(audio_vocab=32, num_quantizers=3, hidden=64, num_layers=2, num_heads=4,
             max_position=512)
# one (phone, prompt) bucket: 16-step ladders, 19-29 phones, prompts 0.18-0.19 s (grid 0.02 s)
SERVICE = dict(len_step=16, max_phone_len=32, max_prompt_len=32, max_new=20,
               audio_grid_s=0.02)
EOS_BIAS = 1.0  # raises the EOS logit: request 0 stops at its EOS


def fill(shapes, seed: int):
    """Random leaves for a Flax tree: kernels normal over √fan_in, norm and
    weight-norm scales and Snake α in [0.5, 1.5], biases small, the rest
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


def _audio(seconds: float, seed: int) -> np.ndarray:
    t = np.arange(int(SR * seconds)) / SR
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * (150 + 40 * seed) * t)
            + 0.03 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """JAX (model, tree, tokenizer, g2p, table) and the port's (model,
    tokenizer, g2p, table) from the same weights."""
    num_phones = max(len(CHARS) + 2, 64)
    jm = jvalle.VALLE(jvalle.VALLEConfig(num_phones=num_phones, **VOCAB))
    args = (jnp.zeros((2, 5), jnp.int32), jnp.ones((2, 5)), jnp.zeros((2, 3, 6), jnp.int32),
            jnp.ones((2, 6)), jax.random.key(0))
    tree = fill(jax.eval_shape(lambda: jm.init(jax.random.key(0), *args,
                                               method=jvalle.VALLE.train_loss))["params"], 3)
    tree["ar_head"]["bias"][VOCAB["audio_vocab"]] = EOS_BIAS
    jc = JCodec(JCodecConfig(**CODEC))
    ctree = fill(jax.eval_shape(jc.init, jax.random.key(0), jnp.zeros((1, 4 * HOP)))["params"], 4)
    symbols = ["_"] + CHARS
    jtable, table = JSymbolTable.from_symbols(symbols), SymbolTable.from_symbols(symbols)
    port = from_flax(VALLE(VALLEConfig(num_phones=num_phones, **VOCAB)), tree).eval()
    codec = from_flax(AmphionCodec(CodecConfig(**CODEC)), ctree).eval()
    return ((jm, tree, JTokenizer(jc, ctree, SR), JG2P("char"), jtable),
            (port, AudioTokenizer(codec, SR), G2PModule("char"), table))


def _batch_of_three(svc, seeds):
    """The three requests at once (one thread each) → waveforms in order."""
    out = [None] * 3

    def one(i):
        out[i] = svc.synthesize(_audio(0.18 + 0.005 * i, i), *TEXTS[i], seed=seeds[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert all(o is not None for o in out)
    return out


def _recording(mod, into, at: int):
    """``mod.valle_generate_ragged`` recording its (codes, gen_len), rows in
    request order (by phone count, its argument ``at``)."""
    real = mod.valle_generate_ragged
    counts = [len(p) + 1 + len(t) for p, t in TEXTS]

    def run(*a, **kw):
        out = real(*a, **kw)
        order = [np.asarray(a[at]).tolist().index(n) for n in counts]
        into.append([np.asarray(x)[order] for x in out])
        return out
    return run


def test_window_service_matches_jax(models, monkeypatch):
    """Temperature 0, one batch of three in both: each request's codes
    equal JAX's, its waveform within 1e-4 and cut to its own length."""
    (jm, tree, jtok, jg2p, jtable), (port, tok, g2p, table) = models
    kw = dict(SERVICE, max_batch=3, max_wait_ms=60000.0, temperature=0.0,
              compute_dtype="float32")
    got_codes, want_codes = [], []
    monkeypatch.setattr(jvalle, "valle_generate_ragged", _recording(jvalle, want_codes, 3))
    monkeypatch.setattr(service_mod, "valle_generate_ragged",
                        _recording(service_mod, got_codes, 2))
    jsvc = jservice.VALLEService(jm, tree, jtok, jg2p, jtable, **kw)
    want = _batch_of_three(jsvc, [1, 2, 3])
    svc = VALLEService(port, tok, g2p, table, **kw)
    try:
        got = _batch_of_three(svc, [1, 2, 3])
        assert svc.stats()["max_batch"] == 3
    finally:
        svc.shutdown()
    assert len(got_codes) == len(want_codes) == 1
    (gc, gl), (wc, wl) = got_codes[0], want_codes[0]
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(gc, wc)
    # one request stops at its EOS, the others run to max_new: rows cut apart
    assert len(set(wl.tolist())) == 2 and 0 < wl.min() < SERVICE["max_new"]
    for g, w, n in zip(got, want, wl):
        assert g.shape == w.shape == (max(int(n), 1) * HOP,)
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_continuous_batcher_matches_jax_engine(models):
    """Greedy, two slots, chunk 4: three requests (the third admitted when a
    slot frees) give JAX's engine's tokens."""
    (jm, tree, *_), (port, *_) = models
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(1, 20, n), rng.integers(0, 32, m)) for n, m in
            ((13, 9), (20, 15), (7, 4))]
    kw = dict(slots=2, chunk=4, phone_buckets=(32,), prompt_buckets=(16,), max_new=12,
              temperature=0.0)
    jeng = jcontinuous.ContinuousValleBatcher(jm, tree, compute_dtype="float32", **kw)
    eng = ContinuousValleBatcher(port, compute_dtype="float32", **kw)
    assert eng.capacity == jeng.capacity == 32 + 16 + 12 + 4
    for i, (ph, pr) in enumerate(reqs):
        jeng.submit(ph, pr, jax.random.key(i))
        eng.submit(ph, pr, i)
    want, got = jeng.run(), eng.run()
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for rid in want:
        np.testing.assert_array_equal(got[rid].numpy(), want[rid])
    assert eng.stats()["completed"] == 3 and not eng.graphs


def test_continuous_service_matches_window_service(models):
    """After `prewarm`, sampled requests (temperature 1, top-k 8), each on
    its own seed: the engine's tokens equal the window batch's, the
    waveforms within 1e-4; the solo path's tokens are the engine's."""
    _, (port, tok, g2p, table) = models
    kw = dict(SERVICE, top_k=8, compute_dtype="float32")
    window = VALLEService(port, tok, g2p, table, max_batch=3, max_wait_ms=60000.0, **kw)
    cont = ValleContinuousService(port, tok, g2p, table, slots=2, chunk=4, **kw)
    toks = []
    real = service_mod.valle_generate_ragged
    try:
        service_mod.valle_generate_ragged = _recording(service_mod, toks, 2)
        want = _batch_of_three(window, [11, 12, 13])
    finally:
        service_mod.valle_generate_ragged = real
        window.shutdown()
    codes, gen_len = toks[0]
    try:
        cont.prewarm()  # every (phone, prompt) bucket pair, every rung, the tail
        eng = cont.driver.engine
        assert (eng.buckets, eng.out_buckets) == ((16, 32), (16, 32))
        assert cont.stats()["admitted"] == 4 + eng.S and cont.stats()["solo_served"] == 0
        cont.driver.solo_enabled = False  # the three go through the engine
        got = _batch_of_three(cont, [11, 12, 13])
        cont.driver.solo_enabled = True
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=1e-4)
        req = cont._prepare_request(_audio(0.18, 0), *TEXTS[0], 11)
        cont.driver.solo_enabled = False
        engine = cont.driver.submit_wait(req.phone_ids, req.prompt_codes[0], 11)
        cont.driver.solo_enabled = True
        solo = cont._solo_decode(req.phone_ids, req.prompt_codes[0], 11)
        np.testing.assert_array_equal(engine.numpy(), codes[0, 0, :gen_len[0]])
        assert torch.equal(solo, engine) and len(engine) == gen_len[0]
        assert cont.stats()["chunks"] > 0
    finally:
        cont.shutdown()


@pytest.fixture(scope="module")
def cli_config(models, tmp_path_factory):
    """A tiny config over `egs/tts/VALLE/exp_config.json`, its symbol table
    and port checkpoints of the models (VALL-E under
    ``log_dir/valle/checkpoint``, the codec on its own)."""
    _, (port, tok, _, table) = models
    root = tmp_path_factory.mktemp("valle")
    cfg = {"base_config": str(REPO / "egs/tts/VALLE/exp_config.json"), "dataset": ["tiny"],
           "log_dir": str(root / "ckpts"),
           "preprocess": {"sample_rate": SR, "processed_dir": str(root / "processed")},
           "model": {"valle": VOCAB, "codec": {k: v for k, v in CODEC.items()
                                               if k != "sample_rate"}}}
    path = root / "tiny.json"
    path.write_text(json.dumps(cfg))
    # the table the models were drawn for has one more symbol: num_phones = 64 either way
    table.to_file(root / "processed" / "tiny" / "symbols.dict")

    def save(module, where):
        state = types.SimpleNamespace(state_dict=lambda: {"model": module.state_dict()})
        CheckpointManager(where).save(state, 1, 10, 0.0)
    save(port, root / "ckpts" / "valle" / "checkpoint")
    save(tok.codec, root / "codec")
    return root, path


def test_http_valle_round_trip(cli_config):
    """`bins/serve.py --backend valle` as a user starts it (continuous by
    default): three requests under a fixed Poisson trace, each a
    well-formed wav of a whole number of codec frames."""
    root, path = cli_config
    args = serve_cli.parse_args([
        "--backend", "valle", "--config", str(path), "--exp_name", "valle", "--codec_ckpt",
        str(root / "codec"), "--device", "cpu", "--port", "0", "--compute_dtype", "float32",
        "--slots", "2", "--chunk", "4", "--len_step", "16", "--max_phone_len", "32",
        "--max_prompt_len", "32", "--max_new", "16"])
    assert args.batcher == "continuous"
    backend = serve_cli.BUILDERS["valle"](args)
    httpd = serve_cli.serve(backend.synth, backend.stats, "valle", port=0,
                            input_sr=backend.sample_rate)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    replies = {}
    submit = loadgen.http_synthesize_submit(url, timeout_s=120)

    def make_request(i):
        wav = serve_cli._encode_wav_bytes(_audio(0.15 + 0.01 * i, i), SR)
        return {"prompt_wav": base64.b64encode(wav).decode(), "prompt_text": TEXTS[i][0],
                "target_text": TEXTS[i][1], "seed": 60 + i}

    def keep(payload):
        replies[payload["seed"]] = submit(payload)
    try:
        res = loadgen.run_trace(keep, make_request, loadgen.poisson_arrivals(20.0, 3, seed=2),
                                drain_timeout_s=120)
        with urllib.request.urlopen(url + "/api/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
        backend.shutdown()
    assert res.n_ok == 3 and res.n_err == 0
    assert stats["batcher"] == "continuous" and stats["admitted"] + stats["solo_served"] >= 3
    for i in range(3):
        with wave.open(io.BytesIO(replies[60 + i])) as w:
            assert (w.getframerate(), w.getnchannels(), w.getsampwidth()) == (SR, 1, 2)
            n = w.getnframes()
            pcm = np.frombuffer(w.readframes(n), np.int16)
        assert 0 < n <= 16 * HOP and n % HOP == 0 and np.abs(pcm).max() > 0
