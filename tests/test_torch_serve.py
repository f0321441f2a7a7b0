"""PyTorch port, Vevo serving with the continuous engine and the HTTP CLI,
on the CPU (the engine steps eagerly there; no JAX is needed: the port's
continuous service is held against the port's window service).

- `VevoContinuousService` against the window `VevoService` with the same
  seeds: voice (through the engine, and through the solo path) and timbre
  waveforms within 1e-4; the solo path's tokens equal the engine's.
- `bins/serve.py`: an HTTP round trip with the ``sine`` backend, and with
  the ``vevo`` backend built by `_build_vevo_service` from a tiny config
  and port checkpoints, driven by `serving/loadgen.py`'s fixed Poisson
  trace: every response a well-formed wav, `/api/stats` the continuous
  engine's.
"""

import argparse
import base64
import io
import json
import threading
import types
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from amphion_tpu_torch.bins import serve as serve_cli
from amphion_tpu_torch.pipelines.vevo_pipeline import build_vevo_voice, vevo_modules
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.serving import loadgen
from amphion_tpu_torch.serving.continuous_service import VevoContinuousService
from amphion_tpu_torch.serving.service import VevoService
from amphion_tpu_torch.utils.config import load_config

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)


REPO = Path(__file__).resolve().parents[1]
SR = 24000
TINY = {"ar": {"hidden": 32, "num_layers": 2, "num_heads": 2, "intermediate": 64},
        "fm": {"hidden": 32, "num_layers": 2, "num_heads": 2},
        "vocos": {"dim": 16, "intermediate_dim": 32, "num_layers": 1},
        "style_tokenizer": {"hidden": 16, "codebook_dim": 4, "num_blocks": 1},
        "content_tokenizer": {"hidden": 16, "codebook_dim": 4, "num_blocks": 1}}
SERVICE = dict(len_step=16, max_content_len=64, max_prompt_len=48, max_new=12,
               flow_matching_steps=2, top_k=5, audio_grid_s=0.25)


def _audio(seed: int, seconds: float) -> np.ndarray:
    t = np.arange(int(SR * seconds)) / SR
    rng = np.random.default_rng(seed)
    tone = np.sin(2 * np.pi * (120 + 30 * seed) * t) * (0.5 + 0.5 * np.sin(5 * t))
    return (0.3 * tone + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def pipe():
    cfg = load_config(REPO / "config" / "vevo.json")
    for name, widths in TINY.items():
        cfg["model"].setdefault(name, {}).update(widths)
    return build_vevo_voice(cfg, seed=3, device="cpu", compute_dtype="float32")


@pytest.fixture(scope="module")
def services(pipe):
    window = VevoService(pipe, max_batch=1, max_wait_ms=0, **SERVICE)
    cont = VevoContinuousService(pipe, slots=2, chunk=4, **SERVICE)
    yield window, cont
    window.shutdown()
    cont.shutdown()


def test_continuous_service_matches_window_service(services):
    """Three concurrent voice requests through the engine, one lone voice
    request through the solo path and one timbre request, each against the
    window service's waveform for the same seed; the solo path's tokens are
    the engine's."""
    window, cont = services
    pairs = [(_audio(i, 0.3 + 0.05 * i), _audio(7 + i, 0.35)) for i in range(3)]
    out = [None] * 3

    def one(i):
        out[i] = cont.synthesize(*pairs[i], mode="voice", seed=40 + i)

    cont.driver.solo_enabled = False  # the three go through the engine
    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        cont.driver.solo_enabled = True
    assert all(o is not None for o in out)
    for (src, ref), wav, seed in zip(pairs, out, range(40, 43)):
        want = window.synthesize(src, ref, mode="voice", seed=seed)
        assert wav.shape == want.shape and len(wav) % 120 == 0 and np.isfinite(wav).all()
        np.testing.assert_allclose(wav, want, atol=1e-4)
    solo_before = cont.stats()["solo_served"]
    lone = cont.synthesize(*pairs[0], mode="voice", seed=40)
    assert cont.stats()["solo_served"] == solo_before + 1
    np.testing.assert_allclose(lone, out[0], atol=1e-4)
    timbre = cont.synthesize(*pairs[1], mode="timbre", seed=5)
    np.testing.assert_allclose(timbre, window.synthesize(*pairs[1], mode="timbre", seed=5),
                               atol=1e-4)
    req = cont._prepare_request(*pairs[2], "voice", 42)
    cont.driver.solo_enabled = False
    try:
        engine = cont.driver.submit_wait(req.content, 85, prompt_output=req.prompt_out)
    finally:
        cont.driver.solo_enabled = True
    solo = cont._solo_decode(req.content, 85, prompt_output=req.prompt_out)
    assert torch.equal(solo, engine) and len(engine) > 0
    stats = cont.stats()
    assert stats["batcher"] == "continuous" and stats["chunks"] > 0 and not stats["graphs"]


def test_continuous_service_prewarm_and_errors(services):
    """`prewarm` walks every bucket pair, every rung and the FM tail; an
    over-long prompt and an unknown mode raise to the caller."""
    _, cont = services
    admitted, chunks = cont.stats()["admitted"], cont.stats()["chunks"]
    cont.prewarm()
    eng = cont.driver.engine
    pairs = len(eng.buckets) * len(eng.out_buckets)
    assert cont.stats()["admitted"] == admitted + pairs + eng.S
    assert cont.stats()["chunks"] > chunks and not eng.queue
    with pytest.raises(ValueError, match="exceeds bucket"):
        cont.driver.submit_wait(np.zeros(65, np.int64), 0, timeout=60)
    with pytest.raises(ValueError, match="unknown Vevo mode"):
        cont.synthesize(_audio(0, 0.3), _audio(1, 0.3), mode="sing")


def _wav_bytes(x: np.ndarray) -> bytes:
    return serve_cli._encode_wav_bytes(x, SR)


def _read_wav(data: bytes) -> tuple[int, np.ndarray]:
    with wave.open(io.BytesIO(data)) as w:
        assert w.getnchannels() == 1 and w.getsampwidth() == 2
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), np.int16)


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _serving(backend):
    httpd = serve_cli.serve(backend.synth, backend.stats, "test", port=0,
                            input_sr=backend.sample_rate)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, th, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, th, backend):
    httpd.shutdown()
    httpd.server_close()
    th.join(timeout=30)
    backend.shutdown()
    assert not th.is_alive()


def test_http_sine_round_trip():
    args = serve_cli.parse_args(["--backend", "sine", "--max_wait_ms", "1"])
    assert args.batcher == "window"
    backend = serve_cli._build_sine_service(args)
    httpd, th, url = _serving(backend)
    try:
        assert _get(url + "/api/health") == {"status": "ok", "backend": "test",
                                             "batching": True}
        submit = loadgen.http_synthesize_submit(url)
        body = {"prompt_wav": base64.b64encode(_wav_bytes(_audio(0, 0.2))).decode(),
                "target_sec": 0.5}
        sr, pcm = _read_wav(submit(body))
        assert sr == SR and len(pcm) == SR // 2
        with pytest.raises(urllib.error.HTTPError):
            submit({"target_sec": 0.5})  # no prompt_wav: a 500
        assert _get(url + "/api/stats")["completed"] == 1
    finally:
        _stop(httpd, th, backend)
    # every backend of the JAX server is served; valle's own round trip is in
    # tests/test_torch_valle_serve.py
    assert serve_cli.BUILDERS["valle"] is serve_cli._build_valle_service


@pytest.fixture(scope="module")
def vevo_args(tmp_path_factory):
    """A tiny config over config/vevo.json and FM and AR checkpoints of it
    in the port trainer's layout, as `bins/vc/train.py` would leave them."""
    root = tmp_path_factory.mktemp("serve")
    cfg = {"base_config": str(REPO / "config" / "vevo.json"), "log_dir": str(root / "ckpts"),
           "model": TINY}
    path = root / "tiny.json"
    path.write_text(json.dumps(cfg))
    torch.manual_seed(11)
    mods = vevo_modules(load_config(path), voice=True)
    for name in ("fm", "ar"):
        state = types.SimpleNamespace(state_dict=lambda m=mods[name]: {"model": m.state_dict()})
        CheckpointManager(root / "ckpts" / name / "checkpoint").save(state, 0, 0, 0.0)
    return serve_cli.parse_args([
        "--backend", "vevo", "--vevo_mode", "voice", "--config", str(path), "--fm_exp", "fm",
        "--ar_exp", "ar", "--compute_dtype", "float32", "--device", "cpu", "--max_new", "8",
        "--fm_steps", "2", "--len_step", "16", "--max_prompt_len", "48", "--slots", "2",
        "--chunk", "4"])


def test_http_vevo_round_trip_under_loadgen(vevo_args):
    args = vevo_args
    assert args.batcher == "continuous"
    backend = serve_cli._build_vevo_service(args)
    httpd, th, url = _serving(backend)
    try:
        clips = [(_audio(i, 0.3), _audio(5 + i, 0.25 + 0.05 * i)) for i in range(3)]

        def make_request(i):
            src, ref = clips[i % 3]
            return {"src_wav": base64.b64encode(_wav_bytes(src)).decode(),
                    "prompt_wav": base64.b64encode(_wav_bytes(ref)).decode(), "seed": i}

        replies = []
        submit = loadgen.http_synthesize_submit(url)

        def keep(payload):
            replies.append(submit(payload))

        res = loadgen.run_trace(keep, make_request, loadgen.poisson_arrivals(20.0, 4, seed=1))
        assert res.n_ok == 4 and res.n_err == 0 and res.latency_ms_p50 > 0
        for data in replies:
            sr, pcm = _read_wav(data)
            assert sr == SR and 0 < len(pcm) <= 8 * 120 and len(pcm) % 120 == 0
        stats = _get(url + "/api/stats")
        assert stats["batcher"] == "continuous" and stats["admitted"] >= 2
        assert stats["chunks"] > 0 and stats["mean_slot_occupancy"] > 0
    finally:
        _stop(httpd, th, backend)
    no_ar = argparse.Namespace(**{**vars(args), "ar_exp": ""})
    with pytest.raises(SystemExit, match="AR weights"):
        serve_cli._build_vevo_service(no_ar)
