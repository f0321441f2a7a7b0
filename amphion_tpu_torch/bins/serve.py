"""Batched zero-shot serving over HTTP (port of `bins/serve.py` and the
helpers it takes from `bins/demo_server.py`): a `ThreadingHTTPServer`
accepts concurrent requests and a service batches them on the card.

    python -m amphion_tpu_torch.bins.serve --backend vevo --vevo_mode voice \\
        --config <exp config> --fm_exp fm --ar_exp ar --compute_dtype int8 \\
        [--batcher continuous] [--prewarm] [--device cuda] [--port 7860]

API (the schema of the JAX server):
  GET  /            → HTML page
  GET  /api/health  → {"status": "ok", "backend": ..., "batching": true}
  GET  /api/stats   → the dispatcher's metrics (continuous: slots, chunks,
                      occupancy, AR latency percentiles; window: batch
                      sizes and waits)
  POST /api/synthesize
       {"prompt_wav": <base64 WAV>, "src_wav": <base64 WAV> (vevo),
        "prompt_text": str, "target_text": str, "target_sec": float|null,
        "seed": int|null}
       → audio/wav bytes (PCM16)

    python -m amphion_tpu_torch.bins.serve --backend maskgct \
        --config egs/tts/MaskGCT/exp_config.json [--exp_name maskgct] \
        [--semantic_ckpt DIR] [--codec_ckpt DIR] [--weights_dir DIR]

    python -m amphion_tpu_torch.bins.serve --backend valle \
        --config egs/tts/VALLE/exp_config.json --exp_name <exp> \
        [--codec_ckpt DIR] [--compute_dtype int8] [--batcher window]

Backends: ``maskgct`` (the default: zero-shot TTS, `MaskGCTService` over
`bins/tts/inference.build_maskgct_pipeline`; requests carry ``prompt_wav``,
``prompt_text``, ``target_text`` and optionally ``target_sec``), ``valle``
(zero-shot TTS over `bins/tts/inference.build_valle`: VALL-E from the port
checkpoint at ``log_dir/<exp_name>/checkpoint``, the codec from
``--codec_ckpt`` or random; requests carry ``prompt_wav``, ``prompt_text``
and ``target_text``, the length follows the AR's EOS), ``vevo``
(Vevo-Timbre or Vevo-Voice, `--vevo_mode`; the FM and AR restored from the
port trainer's checkpoints, `bins/vc/inference.py`) and ``sine`` (a tone
through the window batcher, to test the plumbing without checkpoints).
The vevo and valle backends default to the continuous batcher
(`serving/continuous_service.py`); ``--batcher window`` restores the window
batcher; maskgct and sine have no AR decode and always use the window
batcher. The port adds ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import tempfile
import threading
import wave
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>Amphion zero-shot serving</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:640px;margin:2rem auto;padding:0 1rem}
 label{display:block;margin:.8rem 0 .2rem;font-weight:600}
 input,textarea{width:100%;box-sizing:border-box;padding:.4rem}
 button{margin-top:1rem;padding:.5rem 1.5rem;font-size:1rem}
 #status{margin-top:1rem;color:#555}
</style></head><body>
<h1>Amphion zero-shot serving</h1>
<label>Prompt WAV (3&ndash;10 s reference speech)</label>
<input type="file" id="wav" accept=".wav,audio/wav">
<label>Source WAV (vevo: the speech to convert)</label>
<input type="file" id="src" accept=".wav,audio/wav">
<label>Prompt text (transcript of the prompt)</label>
<textarea id="ptext" rows="2"></textarea>
<label>Target text</label>
<textarea id="ttext" rows="3"></textarea>
<label>Target length in seconds (blank = proportional estimate)</label>
<input type="number" id="tsec" step="0.1" min="0">
<button id="go">Synthesize</button>
<div id="status"></div>
<audio id="out" controls style="display:none;margin-top:1rem;width:100%"></audio>
<script>
const b64 = buf => btoa(new Uint8Array(buf).reduce((s,b)=>s+String.fromCharCode(b),""));
document.getElementById("go").onclick = async () => {
  const f = document.getElementById("wav").files[0];
  const src = document.getElementById("src").files[0];
  const status = document.getElementById("status");
  if (!f) { status.textContent = "pick a prompt wav first"; return; }
  status.textContent = "synthesizing…";
  const body = {
    prompt_wav: b64(await f.arrayBuffer()),
    prompt_text: document.getElementById("ptext").value,
    target_text: document.getElementById("ttext").value,
    target_sec: parseFloat(document.getElementById("tsec").value) || null,
  };
  if (src) body.src_wav = b64(await src.arrayBuffer());
  const r = await fetch("/api/synthesize", {method:"POST",
    headers:{"Content-Type":"application/json"}, body: JSON.stringify(body)});
  if (!r.ok) { status.textContent = "error: " + await r.text(); return; }
  const url = URL.createObjectURL(await r.blob());
  const out = document.getElementById("out");
  out.src = url; out.style.display = "block"; out.play();
  status.textContent = "done";
};
</script></body></html>"""


def _decode_wav_bytes(data: bytes, target_sr: int) -> np.ndarray:
    """An uploaded WAV as float32 mono at ``target_sr``."""
    from amphion_tpu_torch.data.audio_io import load_wav

    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        f.write(data)
        f.flush()
        audio, _ = load_wav(f.name, sr=target_sr)
    return audio


def _encode_wav_bytes(x: np.ndarray, sr: int) -> bytes:
    x = np.clip(np.asarray(x, np.float32).reshape(-1), -1.0, 1.0)
    pcm = (x * 32767.0).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


@dataclass
class Backend:
    """What a builder hands the server: ``synth(prompt_audio, prompt_text,
    target_text, target_sec, seed, src_audio=None) -> (wav, sr)``, the stats
    callable, the input sample rate, and the service's ``prewarm`` and
    ``shutdown`` (None where it has none)."""

    synth: Callable
    stats: Callable[[], dict]
    sample_rate: int
    prewarm: Callable[[], None] | None = None
    shutdown: Callable[[], None] | None = None


def _build_sine_service(args) -> Backend:
    """Checkpoint-free backend that still goes through the window batcher."""
    from amphion_tpu_torch.serving.batcher import MicroBatcher

    sr = 24000

    def run_batch(bucket, payloads):
        out = []
        for (n,) in payloads:
            t = np.arange(n, dtype=np.float32) / sr
            out.append(0.3 * np.sin(2 * np.pi * 220.0 * t))
        return out

    mb = MicroBatcher(run_batch, bucket_fn=lambda p: p[0] // (sr // 2),
                      max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)

    def synth(prompt_audio, prompt_text, target_text, target_sec, seed, src_audio=None):
        if target_sec is None:
            ratio = max(len(target_text), 1) / max(len(prompt_text), 1)
            target_sec = min(max(len(prompt_audio) / sr * ratio, 0.2), 30.0)
        return mb((int(target_sec * sr),)), sr

    return Backend(synth, mb.stats.snapshot, sr, shutdown=mb.shutdown)


def _build_vevo_service(args) -> Backend:
    """Batched zero-shot Vevo VC over `bins/vc/inference.build_pipeline`.
    Requests carry both waveforms: ``src_wav`` (content) and ``prompt_wav``
    (the timbre and style reference); ``--vevo_mode`` picks the product
    (timbre: FM only; voice: AR + FM)."""
    from amphion_tpu_torch.bins.vc.inference import build_pipeline
    from amphion_tpu_torch.serving.service import VevoService
    from amphion_tpu_torch.utils.config import load_config
    from amphion_tpu_torch.utils.logging import get_logger

    cfg = load_config(args.config)
    pipe, has_vocoder = build_pipeline(args, cfg, get_logger("serve"), device=args.device,
                                       compute_dtype=args.compute_dtype)
    if not has_vocoder:
        print("WARNING: no vocoder ckpt, RANDOM Vocos weights (smoke only)")
    mode = args.vevo_mode
    if mode == "voice" and pipe.ar is None:
        raise SystemExit("--vevo_mode voice needs AR weights (--ar_exp)")
    common = dict(len_step=args.len_step, max_prompt_len=args.max_prompt_len,
                  max_new=args.max_new, flow_matching_steps=args.fm_steps,
                  fm_solver=args.fm_solver)
    prewarm = None
    if args.batcher == "continuous":
        from amphion_tpu_torch.serving.continuous_service import VevoContinuousService

        svc = VevoContinuousService(pipe, slots=args.slots, chunk=args.chunk, **common)
        prewarm = svc.prewarm
    else:
        svc = VevoService(pipe, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                          **common)
    sr = cfg["preprocess"]["sample_rate"]

    def synth(prompt_audio, prompt_text, target_text, target_sec, seed, src_audio=None):
        if src_audio is None:
            raise ValueError("vevo backend needs 'src_wav' in the request")
        return svc.synthesize(src_audio, prompt_audio, mode=mode, seed=seed), sr

    return Backend(synth, svc.stats, sr, prewarm, svc.shutdown)


def _build_maskgct_service(args) -> Backend:
    """Batched MaskGCT zero-shot TTS over `bins/tts/inference.
    build_maskgct_pipeline`. A request's ``target_sec`` becomes
    ``target_sec · semantic_rate`` target frames, as in JAX."""
    from amphion_tpu_torch.bins.tts.inference import build_maskgct_pipeline
    from amphion_tpu_torch.serving.service import MaskGCTService
    from amphion_tpu_torch.utils.config import load_config
    from amphion_tpu_torch.utils.logging import get_logger

    if args.compute_dtype not in ("float32", "bfloat16"):
        raise SystemExit(f"--compute_dtype {args.compute_dtype}: MaskGCT serves float32 "
                         "or bfloat16")
    cfg = load_config(args.config)
    pipe = build_maskgct_pipeline(args, cfg, get_logger("serve"), device=args.device,
                                  compute_dtype=args.compute_dtype)
    svc = MaskGCTService(pipe, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                         len_step=args.len_step, max_prompt_len=args.max_prompt_len,
                         max_target_len=args.max_target_len,
                         max_phone_len=args.max_phone_len)

    def synth(prompt_audio, prompt_text, target_text, target_sec, seed, src_audio=None):
        target_len = None if target_sec is None else int(target_sec * pipe.semantic_rate)
        wav = svc.synthesize(prompt_audio, prompt_text, target_text, target_len=target_len,
                             seed=seed)
        return wav, pipe.sample_rate

    return Backend(synth, svc.stats, pipe.sample_rate, shutdown=svc.shutdown)


def _build_valle_service(args) -> Backend:
    """Batched zero-shot VALL-E over `bins/tts/inference.build_valle` (the
    weights at ``log_dir/<exp_name>/checkpoint``, the codec's
    ``--codec_ckpt``): the continuous engine on the AR stage by default,
    ``--batcher window`` the window `VALLEService`."""
    from amphion_tpu_torch.bins.tts.inference import build_valle
    from amphion_tpu_torch.serving.service import VALLEService
    from amphion_tpu_torch.utils.config import load_config
    from amphion_tpu_torch.utils.logging import get_logger

    cfg = load_config(args.config)
    model, tok, g2p, symbols = build_valle(args, cfg, get_logger("serve"), device=args.device)
    common = dict(len_step=args.len_step, max_phone_len=args.max_phone_len,
                  max_prompt_len=args.max_prompt_len, max_new=args.max_new,
                  compute_dtype=args.compute_dtype)
    prewarm = None
    if args.batcher == "continuous":
        from amphion_tpu_torch.serving.continuous_service import ValleContinuousService

        svc = ValleContinuousService(model, tok, g2p, symbols, slots=args.slots,
                                     chunk=args.chunk, **common)
        prewarm = svc.prewarm
    else:
        svc = VALLEService(model, tok, g2p, symbols, max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms, **common)

    def synth(prompt_audio, prompt_text, target_text, target_sec, seed, src_audio=None):
        return svc.synthesize(prompt_audio, prompt_text, target_text, seed=seed), tok.sample_rate

    return Backend(synth, svc.stats, tok.sample_rate, prewarm, svc.shutdown)


def make_handler(synth_fn, stats_fn, backend_name: str, input_sr: int = 24000):
    """The request handler class; requests without a ``seed`` take the
    next of a counter this handler class owns."""
    seed_lock = threading.Lock()
    last_seed = [0]

    def next_seed() -> int:
        with seed_lock:
            last_seed[0] += 1
            return last_seed[0]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/api/health":
                self._send(200, json.dumps({"status": "ok", "backend": backend_name,
                                            "batching": True}).encode(), "application/json")
            elif self.path == "/api/stats":
                self._send(200, json.dumps(stats_fn()).encode(), "application/json")
            elif self.path in ("/", "/index.html"):
                self._send(200, PAGE.encode(), "text/html; charset=utf-8")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/api/synthesize":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n))
                # inbound audio at the pipeline's own rate
                prompt = _decode_wav_bytes(base64.b64decode(req["prompt_wav"]), input_sr)
                src = (_decode_wav_bytes(base64.b64decode(req["src_wav"]), input_sr)
                       if "src_wav" in req else None)
                seed = req.get("seed")
                wav, sr = synth_fn(prompt, req.get("prompt_text", ""),
                                   req.get("target_text", ""), req.get("target_sec"),
                                   next_seed() if seed is None else int(seed), src_audio=src)
                self._send(200, _encode_wav_bytes(wav, sr), "audio/wav")
            except Exception as e:  # the server's boundary: report, keep serving
                self._send(500, str(e).encode(), "text/plain")

    return Handler


def serve(synth_fn, stats_fn, backend_name="custom", port=7860, host="127.0.0.1",
          input_sr: int = 24000) -> ThreadingHTTPServer:
    """The server, bound and not yet serving (port 0: one the OS picks)."""
    return ThreadingHTTPServer((host, port),
                               make_handler(synth_fn, stats_fn, backend_name, input_sr))


BUILDERS = {"sine": _build_sine_service, "vevo": _build_vevo_service,
            "maskgct": _build_maskgct_service, "valle": _build_valle_service}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="maskgct", choices=sorted(BUILDERS))
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--config", help="experiment config (maskgct, valle, vevo)")
    ap.add_argument("--exp_name", default="maskgct")
    ap.add_argument("--semantic_ckpt", default=None)
    ap.add_argument("--codec_ckpt", default=None)
    ap.add_argument("--weights_dir", default=None)
    ap.add_argument("--batcher", default="continuous", choices=["continuous", "window"],
                    help="AR-backend dispatcher (vevo, valle): 'continuous' (default) admits "
                         "requests into a live per-slot decode at chunk boundaries; "
                         "'window' is the static micro-batcher; maskgct and sine always "
                         "use it")
    ap.add_argument("--slots", type=int, default=4, help="continuous engine decode slots")
    ap.add_argument("--prewarm", action="store_true",
                    help="walk the continuous engine's buckets and rungs and the tail "
                         "(vevo: FM, valle: NAR and codec) before listening")
    ap.add_argument("--chunk", type=int, default=64,
                    help="continuous engine decode chunk (steps between admission points)")
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--max_wait_ms", type=float, default=50.0)
    ap.add_argument("--len_step", type=int, default=64)
    ap.add_argument("--max_prompt_len", type=int, default=512)
    ap.add_argument("--max_target_len", type=int, default=1024)
    ap.add_argument("--max_phone_len", type=int, default=512)
    ap.add_argument("--max_new", type=int, default=768, help="AR decode budget (vevo, valle)")
    ap.add_argument("--vevo_mode", default="timbre", choices=["timbre", "voice"],
                    help="vevo product: timbre = FM re-render, voice = AR style rewrite + FM")
    ap.add_argument("--fm_steps", type=int, default=32)
    ap.add_argument("--fm_solver", default="euler", choices=["euler", "midpoint"])
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["float32", "bfloat16", "int8", "int4"],
                    help="AR and FM dtype (vevo; int8/int4 decode rows independently of "
                         "their batch), AR and NAR dtype (valle; int8/int4 quantize the AR, "
                         "the NAR runs bf16), T2S and S2A dtype (maskgct: float32 or "
                         "bfloat16)")
    ap.add_argument("--ar_exp", default="", help="vevo AR trainer exp_name")
    ap.add_argument("--fm_exp", default="", help="vevo FM trainer exp_name")
    ap.add_argument("--content_ckpt", default="")
    ap.add_argument("--style_ckpt", default="")
    ap.add_argument("--vocoder_ckpt", default="")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.batcher == "continuous" and args.backend in ("maskgct", "sine"):
        print(f"NOTE: backend '{args.backend}' has no AR decode stage; falling back to the "
              "window batcher (continuous batching applies to the AR backends)")
        args.batcher = "window"
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    from amphion_tpu_torch.utils.device import strict_float32

    strict_float32()
    backend = BUILDERS[args.backend](args)
    try:
        if args.prewarm and backend.prewarm is not None:
            print("prewarming (every bucket pair, every rung, the tail)...")
            backend.prewarm()
            print("prewarm done")
        httpd = serve(backend.synth, backend.stats, args.backend, args.port, args.host,
                      input_sr=backend.sample_rate)
        print(f"batched serving on http://{args.host}:{httpd.server_address[1]} "
              f"(backend={args.backend}, batcher={args.batcher})")
        with httpd:
            httpd.serve_forever()
    finally:
        if backend.shutdown is not None:
            backend.shutdown()


if __name__ == "__main__":
    main()
