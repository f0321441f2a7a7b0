#!/usr/bin/env python3
"""Drive the PyTorch port (`amphion_tpu_torch`) on one CUDA card.

Builds the ten CUDA kernels from ``amphion_tpu_torch/ops/kernels/csrc``
with nvcc (one process each, in parallel) and holds each against its plain
PyTorch version (the mel at the Vevo and the bigvgan_large front ends,
also against float64 and for bit-equal relaunches; the flash-attention
forward and backward in bf16 and float32, both for bit-equal relaunches,
the backward also against float64 autograd; Snake's forward and backward
and the anti-aliased SnakeBeta in float32 and bf16, ragged and short
signals). Then,
at the full width of ``config/vevo.json`` with random weights from
``--seed``:

- Vevo training: the FM and the AR trainer, each for 8 steps in float32
  through `amphion_tpu_torch.bins.vc.train.main` on a synthetic corpus
  (flash-attention forward and backward kernels in every layer, mel kernel
  in the batch maker), with a checkpoint at step 4 and a resume from it that
  must repeat steps 5-8; a small FM and AR step on the card against the CPU;
- Vevo-Timbre: four concurrent requests (mel and flash-attention kernels);
- Vevo-Voice: four concurrent requests in int8, then in int4 (AR decode of
  ``--max-new`` steps through the int8/int4 matmul kernels, the RMSNorm and
  lm_head kernels and the int8 KV cache, then flow matching through the
  same matmul kernels), request 0 alone equal to request 0 in the batch;
- one single-utterance int8 Vevo-Voice run with the fused decode-attention
  kernel (``AMPHION_FUSED_DECODE_ATTN=1``) and an int4 decode with the
  fused RMSNorm prologue (``AMPHION_FUSED_RMS=1``);
- the continuous engine in int8 and in int4 (its step a CUDA graph per
  rung): four staggered requests through the graph engine and an eager
  engine, each equal to the request's solo decode; every row's logits
  bit-equal at 1, 2, 4 and 8 rows; a bf16 engine's tokens alone and in
  company (reported); then `bins/serve.py` as a user starts it (FM and AR
  checkpoints, `_build_vevo_service`, prewarm, `serve` on 127.0.0.1)
  answering six voice requests from `serving/loadgen.py`;
- BigVGAN copy synthesis at the width of
  ``egs/vocoder/gan/bigvgan/exp_config.json`` through
  `amphion_tpu_torch.bins.vocoder.inference.main` on six files of 2-10 s
  (mel kernel, anti-aliased SnakeBeta kernel in all 73 activations), a
  small generator on the card against the CPU, and Snake's kernel driven
  through ``Snake(use_pallas=True)``;
- BigVGAN GAN training at the width and batch of
  ``egs/vocoder/gan/bigvgan/exp_config.json`` (MPD + MSD, 16 x 64 frames)
  through `amphion_tpu_torch.bins.vocoder.train.main`: 8 float32 steps on
  a synthetic corpus with a checkpoint at step 4 and a resume from it that
  must repeat steps 5-8 (kernel 2 in both generator forwards, 146 a step;
  kernel 3 three times a step, once under grad through `LogMelFn`), the
  trained checkpoint through the vocoder inference CLI, `LogMelFn` on the
  step's own input, a profiled step pair and both backwards timed; two
  steps of ``egs/vocoder/gan/bigvgan_large`` (MPD + MRD); and a small GAN
  step on the card against the CPU;
- the other GAN vocoders: each remaining ``egs/vocoder/gan`` recipe
  (hifigan, melgan, apnet with the base preprocess's STFT as its missing
  ``model.apnet`` block, vocos, nsfhifigan, tfr_enhanced_hifigan with
  MS-SB-CQT) at its width and batch for 3 float32 steps through
  `bins/vocoder/train.main` (kernel 3 three times a step, no other kernel;
  kernel 3 on a step's own real and fake audio against `log_mel_ref` and
  float64), then two files of copy synthesis from the last checkpoint
  through `bins/vocoder/inference.main` (kernel 3 once a file; NSF-HiFiGAN
  raises: the CLI feeds no F0); one HiFi-GAN step against MPD + MS-STFT;
  `yin_f0` on a 220 Hz tone and card against CPU; small HiFi-GAN + MPD +
  MS-SB-CQT and NSF-HiFiGAN steps on the card against the CPU;
- MaskGCT zero-shot TTS as `bins/serve.py` serves it by default, at the
  width of ``egs/tts/MaskGCT/exp_config.json`` (T2S and S2A 1024 x 16
  layers in bf16, the Amphion codec, the mel semantic front end): port
  checkpoints written from random weights, the pipeline built by
  `bins/tts/inference.build_maskgct_pipeline`, four concurrent requests in
  one bucket through `MaskGCTService` (launches: flash 1 664, mel 4, Snake
  145 in the codec, its first model path), each kernel held against its
  plain version on the inputs the batch gave it (flash within the bf16
  tolerance, Snake to the bit, mel within 1e-3), request 0 alone against
  request 0 in the batch (reported), a profiled batch, a small float32
  batch on the card against the CPU with the same injected draws, and
  `bins/serve.py --backend maskgct` answering six requests from
  `serving/loadgen.py`, and `bins/tts/inference.py` in its MaskGCT mode;
- VALL-E zero-shot TTS as `bins/serve.py --backend valle` serves it, at the
  width of ``egs/tts/VALLE/exp_config.json`` (1024 x 12 layers, FFN 2816,
  8 x 1 024 codes; 192 AR steps, the CLI's 768 cut for the run's time): port
  checkpoints from random weights, the model and codec built by
  `bins/tts/inference.build_valle`; the int8 continuous engine (graphs)
  with four requests a chunk apart, each equal to its solo decode and to
  an eager engine's (launches #4 48, `rms_norm` 25 and `bf16_gemv` 1 an AR
  pass), the bf16 window `VALLEService` on a batch of four (#6 84, #1 145,
  `rms_norm` 25 a pass; request 0 alone reported), #6, #1, #4/#5 and the
  1025-wide head GEMV on the paths' recorded inputs (K 1024 and 2816), a
  64-step int4 solo decode, a small float32 VALL-E card vs CPU, `bins/
  serve.py --backend valle` answering six requests at the CLI's defaults,
  and `bins/tts/inference.py` in its VALLE mode;
- VALL-E and MaskGCT training as their recipes run it (`tts_training_phase`):
  96 synthetic LibriTTS-layout clips through `bins/tts/preprocess.py`
  (codes; for MaskGCT semantic tokens and latents; #1 29 and #3 one a file
  or batch), `bins/tts/train.py` at the recipes' widths and ``max_tokens``
  16 000 in float32 (VALL-E 1024 x 12 AR + NAR; T2S and S2A 1024 x 16) for
  4 steps with a checkpoint at step 2 and a resume from it that must repeat
  steps 3-4 to the bit (#6 and #7 24 and 32 a step), `bins/tts/inference.py`
  from the trained checkpoints, small full-width steps card vs CPU, and
  #6/#7 at the recorded training shapes against float64 and timed;
- VITS and FastSpeech2 training and inference as the LJSpeech recipes run
  them (`classic_tts_phase`): 49 synthetic LJSpeech-layout clips of about
  3 s (48 train: one epoch of three batches of 16) with MFA-style
  TextGrids, `bins/tts/preprocess.py`, `bins/tts/train.py` at the widths
  and batch of ``egs/tts/{VITS,FastSpeech2}`` in float32 (VITS: the
  relative-position encoder, posterior WaveNet, flows, alignment search,
  SDP and HiFi-GAN 512 against MPD + MSD; #3 twice a step, the generated
  segments through `LogMelFn`; FastSpeech2: #3 once a step on the batch)
  for 3 steps and a resume of the last, one step of each on 4 rows card vs
  CPU, a profiled step of each (busy share, the alignment's share), the
  inference CLI (VITS; FastSpeech2 with Griffin-Lim and with a HiFi-GAN
  checkpoint), #3 on the runs' recorded inputs against `log_mel_ref` and
  timed at (16, 3 840) and (16, 72 000);

checking outputs, launch counts against counts worked out beforehand and
batch invariance, and holding the int8/int4 matmul kernels against their
plain versions on the inputs the voice paths gave them (decode, AR prefill
and flow-matching rows, with and without the RMSNorm prologue; at the
decode rows also relaunched and row by row, bit for bit, at the GEMM's
rows relaunched; the GEMM's launches counted apart), the decode-attention
kernel on the fused run's own calls at a spread of decode steps (every
layer; relaunched bit for bit, and one CUDA kernel a call) and the
anti-aliased SnakeBeta kernel, to the bit, on the inputs of one 10 s file's
73 activations. It then
measures the eager decode at 1-16 rows, holding row 0's tokens equal up to
8 rows and every PyTorch operation row-invariant, times each kernel at the shapes the
paths gave it (by CUDA-graph replays, beside SDPA timed the same way for
the flash kernels), and profiles a decode chunk of each engine, two steps
of each trainer and one 10 s copy synthesis. Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--max-new 192]

``--max-new`` is the voice window batches' AR depth; the voice engine runs
stop at ``ENGINE_MAX_NEW`` (128) steps and VALL-E's at ``VALLE_MAX_NEW``
(192), cuts made for the run's time. Exits nonzero on any failure, and at
once when there is no CUDA card. The
last three lines of standard output are the ``{"kernels": [...]}`` timing
line, then the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``) on the line before
the last, then ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import argparse
import faulthandler
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback

# the smoke drives one card: the first visible one, whatever the host exposes
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten, tree_unflatten  # noqa: E402

SR, HOP, N_FFT = 24000, 120, 1024
PEAK_BF16, PEAK_F32, PEAK_TF32, HBM = 989e12, 67e12, 495e12, 3.35e12  # H100 SXM data sheet
# (reference seconds, source seconds) of the four requests: one length
# bucket, so the four share one batch of flash-attention shape (4, 1536, 16, 64)
REQUESTS = [(2.0, 4.6), (2.6, 5.5), (3.3, 6.8), (4.0, 8.0)]
# the mel front end of egs/vocoder/gan/bigvgan_large/exp_config.json
MEL_LARGE = {"n_fft": 1024, "win_size": 1024, "hop_size": 256, "n_mel": 100}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def synth_audio(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """Voiced-like test audio: a gliding harmonic tone with tremolo and noise."""
    t = np.arange(int(SR * seconds)) / SR
    f0 = rng.uniform(100, 220) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 6))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t) ** 2
    return (0.2 * x + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)


def gpu_ms(fn, iters: int = 20) -> float:
    """Mean time of ``fn()`` on the card, by CUDA events after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, stream=None) -> float:
    """Mean device time of one ``fn()``, the host's launch overhead taken
    out: ``fn`` is captured ``reps`` times in one CUDA graph, with ``reps``
    (at most 64) chosen so that a replay lasts at least 1 ms and so hides
    the host's cost of launching the next, the graph is replayed ``iters``
    times after warm-up, timed by CUDA events, and the mean replay is
    divided by ``reps``. Warm-up and capture run on ``stream`` (a new side
    stream by default): an autograd backward launches on the stream its
    forward ran on, so timing one means running that forward on it first."""
    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)

    def captured(reps: int):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(reps):
                fn()
        return graph

    one = captured(1)
    est = gpu_ms(one.replay, 5)  # an upper bound: a lone replay may wait on the host
    del one
    reps = max(1, min(64, math.ceil(1.0 / max(est, 1e-4))))
    return gpu_ms(captured(reps).replay, iters) / reps


def check(name: str, ok: bool, detail: str) -> None:
    log(f"  {name}: {detail} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"check failed: {name}: {detail}")


def close_bf16(out, ref) -> tuple[bool, str]:
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    fro = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    return (err <= 2e-2 * scale and fro <= 1e-2,
            f"max|err| {err:.3g} = {err / scale:.3g} max|ref| (tol 2e-2), "
            f"rel Frobenius {fro:.3g} (tol 1e-2)")


def grid_len(seconds: float, grid_s: float = 0.5) -> int:
    """Samples after the service's 0.5 s audio grid padding."""
    g = int(grid_s * SR)
    return max(g, -(-int(SR * seconds) // g) * g)


def kernel_phase(mel_mod, flash_mod, seed: int) -> dict:
    from amphion_tpu_torch.ops.kernels.mel import log_mel_f64
    from amphion_tpu_torch.ops.mel import MelConfig

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(seed)
    cfg = MelConfig()
    errs = {"mel": 0.0, "mel_f64": 0.0, "mel_plain_f64": 0.0, "flash": 0.0}
    log("kernel mel (f32, tol 1e-3 on log-mel against the plain version and against the "
        "same arithmetic in float64; bit-equal on relaunch):")
    shapes = [(cfg, 4, 5 * SR), (cfg, 2, 119 * HOP + 37), (cfg, 1, (N_FFT - HOP) // 2 + 1)]
    shapes += sorted({(cfg, 1, grid_len(s)) for pair in REQUESTS for s in pair},
                     key=lambda c: c[2])
    large = MelConfig(**MEL_LARGE)  # egs/vocoder/gan/bigvgan_large's front end
    shapes += [(large, 4, 3 * SR + 77), (large, 1, (large.n_fft - large.hop_size) // 2 + 1)]
    for c, b, t in shapes:
        y = torch.randn((b, t), generator=g, device=dev) * 0.2
        out = mel_mod.mel_spectrogram(y, c)
        again = mel_mod.mel_spectrogram(y, c)
        ref = mel_mod.mel_spectrogram_ref(y, c)
        f64 = log_mel_f64(y, mel_mod._fbank(c, dev), c.n_fft, c.hop_size, c.win_size, c.clip_val)
        err, err64 = (out - ref).abs().max().item(), (out.double() - f64).abs().max().item()
        plain64 = (ref.double() - f64).abs().max().item()
        errs["mel"] = max(errs["mel"], err)
        errs["mel_f64"] = max(errs["mel_f64"], err64)
        errs["mel_plain_f64"] = max(errs["mel_plain_f64"], plain64)
        same = torch.equal(out, again)
        check(f"mel hop={c.hop_size} n_mel={c.n_mel} B={b} T={t}",
              out.shape == ref.shape and err <= 1e-3 and err64 <= 1e-3 and same,
              f"shape {tuple(out.shape)} max|err| {err:.3g}, against float64 {err64:.3g} "
              f"(plain version {plain64:.3g}); bit-equal on relaunch: {same}")
    cases = [  # b, lq, lk, h, kvh, d, causal, mask
        (4, 1536, 1536, 16, 16, 64, False, True),
        (2, 300, 300, 16, 16, 64, True, True),
        (2, 256, 256, 16, 4, 64, True, False),
        (2, 200, 700, 8, 8, 64, False, True),
        (1, 333, 333, 8, 2, 128, False, True),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        log(f"kernel flash_attn_fwd ({dtype}):")
        for b, lq, lk, h, kvh, d, causal, use_mask in cases:
            q = torch.randn((b, lq, h, d), generator=g, device=dev).to(dtype)
            k = torch.randn((b, lk, kvh, d), generator=g, device=dev).to(dtype)
            v = torch.randn((b, lk, kvh, d), generator=g, device=dev).to(dtype)
            mask = None
            if use_mask:
                valid = torch.tensor([lk - 37 * i for i in range(b)], device=dev)
                mask = (torch.arange(lk, device=dev)[None] < valid[:, None]).float()
            out = flash_mod.flash_attention(q, k, v, mask, causal)
            again = flash_mod.flash_attention(q, k, v, mask, causal)
            ref = flash_mod.attention_ref(q, k, v, mask, causal)
            name = f"B={b} Lq={lq} Lk={lk} H={h} KVH={kvh} D={d} causal={causal} mask={use_mask}"
            if dtype == torch.bfloat16:
                ok, detail = close_bf16(out, ref)
            else:
                err = (out - ref).abs().max().item()
                ok, detail = err <= 1e-4, f"max|err| {err:.3g} (tol 1e-4)"
            if (b, lq, h, d, dtype) == (4, 1536, 16, 64, torch.bfloat16):
                errs["flash"] = (out.float() - ref.float()).abs().max().item()
            same = torch.equal(out, again)
            check(name, ok and same, f"{detail}; bit-equal on relaunch: {same}")
    return errs


def reference_phase(seed: int) -> None:
    """A small float32 pipeline on the card against the same one on the CPU."""
    from amphion_tpu_torch.pipelines.vevo_pipeline import build_vevo_timbre
    from amphion_tpu_torch.utils.config import load_config

    cfg = load_config("config/vevo.json")
    cfg["model"]["fm"].update(hidden=128, num_layers=2, num_heads=2)
    cfg["model"]["vocos"] = {"dim": 64, "intermediate_dim": 128, "num_layers": 2}
    rng = np.random.default_rng(seed + 1)
    src, ref = synth_audio(rng, 1.5), synth_audio(rng, 1.0)
    noise = torch.from_numpy(rng.standard_normal((1, int(1.5 * SR) // HOP, 80))
                             .astype(np.float32))
    outs = {}
    for dev in ("cuda", "cpu"):
        pipe = build_vevo_timbre(cfg, seed, dev, compute_dtype="float32")
        toks = pipe.style_tokens(src).cpu()
        wav = pipe.inference_fm(src, ref, flow_matching_steps=4,
                                noise=noise.to(dev)).cpu()
        outs[dev] = toks, wav
    agree = (outs["cuda"][0] == outs["cpu"][0]).float().mean().item()
    w_gpu, w_cpu = outs["cuda"][1], outs["cpu"][1]
    rel = ((w_gpu - w_cpu).abs().max() / w_cpu.abs().max()).item()
    check("reference: small f32 pipeline, card vs CPU",
          agree >= 0.99 and rel <= 1e-3 and bool(torch.isfinite(w_gpu).all()),
          f"style tokens agree {agree:.4f} (tol 0.99), waveform max|err|/max|wav| "
          f"{rel:.2g} (tol 1e-3)")


def serve(svc, audio: list, seeds: list, mode: str = "timbre") -> tuple[list, list, float]:
    """Submit requests from one thread each; returns (waveforms, latencies, wall)."""
    wavs, lats = [None] * len(audio), [None] * len(audio)

    def one(i):
        t0 = time.perf_counter()
        wavs[i] = svc.synthesize(audio[i][1], audio[i][0], mode=mode, seed=seeds[i])
        lats[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(audio))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads) or any(w is None for w in wavs):
        raise SystemExit("slice: a request did not finish")
    return wavs, lats, wall


def slice_phase(seed: int, mel_k, flash_k) -> dict:
    from amphion_tpu_torch.pipelines.vevo_pipeline import build_vevo_timbre
    from amphion_tpu_torch.serving.service import VevoService
    from amphion_tpu_torch.utils.config import load_config

    cfg = load_config("config/vevo.json")
    t0 = time.perf_counter()
    pipe = build_vevo_timbre(cfg, seed, "cuda")
    n_params = sum(p.numel() for m in (pipe.style_tokenizer, pipe.fm, pipe.vocoder)
                   for p in m.parameters())
    fc = pipe.fm.cfg
    log(f"slice: built full-width Vevo-Timbre ({n_params / 1e6:.1f} M params, FM "
        f"{fc.hidden}x{fc.num_layers}, {fc.num_heads} heads, bf16) in "
        f"{time.perf_counter() - t0:.1f} s")
    svc = VevoService(pipe, max_batch=4, max_wait_ms=2000)
    rng = np.random.default_rng(seed)
    audio = [(synth_audio(rng, r), synth_audio(rng, s)) for r, s in REQUESTS]
    seeds = [seed * 100 + i for i in range(len(audio))]
    try:
        t0 = time.perf_counter()
        solo = svc.batcher.submit(svc._prepare_request(
            audio[0][1], audio[0][0], "timbre", seeds[0])).result(timeout=600)
        torch.cuda.synchronize()
        log(f"slice: request 0 alone (cold) in {time.perf_counter() - t0:.2f} s")

        torch.cuda.reset_peak_memory_stats()
        batches0 = svc.stats()["batches"]
        mel_k.launches = flash_k.launches = 0
        wavs, lats, wall = serve(svc, audio, seeds)
        launches = {"mel": mel_k.launches, "flash_attn_fwd": flash_k.launches}
        n_batches = svc.stats()["batches"] - batches0
        peak = torch.cuda.max_memory_allocated() / 2**30

        log(f"slice: launches {launches} over {n_batches} batch(es)")
        check("mel launches", launches["mel"] == 3 * len(audio),
              f"{launches['mel']} (3 per request)")
        need = fc.num_layers * svc.fm_steps * n_batches
        check("flash launches", launches["flash_attn_fwd"] >= need,
              f"{launches['flash_attn_fwd']} (>= {fc.num_layers} layers x "
              f"{svc.fm_steps} steps x {n_batches} batches)")
        for i, ((r, s), w) in enumerate(zip(REQUESTS, wavs)):
            want = min(grid_len(s) // HOP, svc.max_new) * HOP
            check(f"request {i} waveform", w.shape == (want,) and np.isfinite(w).all()
                  and np.abs(w).max() > 0, f"{w.shape[0]} samples (want {want}), finite")
        diff = np.abs(wavs[0] - solo).max() / np.abs(solo).max()
        check("batch invariance", diff <= 3e-2,
              f"request 0 alone vs in the batch: max|diff|/max|solo| {diff:.3g} (tol 3e-2)")
        audio_out = sum(len(w) for w in wavs) / SR
        perf = {"requests": len(wavs), "batches": n_batches, "batch_wall_s": round(wall, 4),
                "latency_s": [round(x, 4) for x in lats], "audio_s_out": audio_out,
                "audio_s_per_s": round(audio_out / wall, 3),
                "max_memory_allocated_gib": round(peak, 3)}
        log("slice perf: " + json.dumps(perf))
        log("slice trace (profiled rerun): " + json.dumps(profile_rerun(svc, audio, seeds)))

        # the inputs the serving path gave each kernel, for the timing phase
        reqs = [svc._prepare_request(s, r, "timbre", 0) for r, s in audio]
        bucket = svc._bucket_of(reqs[0])
        valid = [len(q.fm_prompt_tokens) + len(q.target_style) for q in reqs]
        mel_inputs = []
        for r, s in audio:
            ref_len, src_len = grid_len(len(r) / SR), grid_len(len(s) / SR)
            mel_inputs += [ref_len, ref_len, src_len]
    finally:
        svc.shutdown()
    return {"launches": launches, "bucket": bucket, "valid": valid,
            "mel_lengths": sorted(mel_inputs), "perf": perf}


# profile group → the substrings a kernel's name must all hold; the first
# group that matches takes it. #4/#5's GEMM (with its bf16 pre-pass,
# `qmm_wgmma` and `qmm_prep`) and their shared GEMV (`gemv_kernel`) are
# instantiated with each format (`Int8`, `Int4`).
KERNEL_GROUPS = [("flash_attn_fwd", ("flash_fwd",)), ("flash_attn_bwd", ("bwd_d",)),
                 ("mel", ("mel_kernel",)),
                 ("int8_gemm", ("qmm_", "::Int8,")), ("int4_gemm", ("qmm_", "::Int4,")),
                 ("int8_gemv", ("gemv_kernel", "::Int8,")),
                 ("int4_gemv", ("gemv_kernel", "::Int4,")),
                 ("decode_attn_int8", ("decode_",)), ]
LIBRARY_GEMM = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")


def device_us_by_name(prof) -> tuple[dict, int]:
    """Device microseconds by kernel name from a finished torch.profiler
    run, and the number of device records."""
    by_name, n = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e3
        n += 1
    return by_name, n


def profile_rerun(svc, audio, seeds, mode: str = "timbre") -> dict:
    """A rerun of the batch under torch.profiler (device activity only):
    wall, device-busy share and device time by group (the port's kernels by
    name, library GEMMs, the rest). The voice batch launches about a million
    kernels, so the kernel records are summed straight from the profiler's
    results instead of through ``key_averages``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, wall = serve(svc, audio, seeds, mode)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups.update(gemm=0.0, other=0.0)
    by_name, n_kernels = device_us_by_name(prof)
    for name, us in by_name.items():
        group = next((g for g, pats in KERNEL_GROUPS if all(p in name for p in pats)), None)
        if group is None:
            group = "gemm" if any(t in name for t in LIBRARY_GEMM) else "other"
        groups[group] += us
    busy = sum(groups.values()) / 1e6
    top = sorted(((us, n[:80]) for n, us in by_name.items()), reverse=True)
    return {"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_records": n_kernels, "summed_in_s": time.perf_counter() - t0,
            "by_group_s": {k: v / 1e6 for k, v in groups.items()},
            "top_kernels_ms": [[n, us / 1e3] for us, n in top[:8]]}


@functools.lru_cache(maxsize=2)
def _stft_window(device) -> torch.Tensor:
    return F.pad(torch.hann_window(480, device=device), ((N_FFT - 480) // 2, (N_FFT - 480) // 2))


def library_mel(y, fb, clip_val: float):
    """The mel of the default config as one chain of PyTorch calls: reflect
    pad, torch.stft (cuFFT), magnitude, mel matmul, log. The yardstick of
    the kernel's ``library_ms``; the port never calls it."""
    pad = (N_FFT - HOP) // 2
    yp = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    spec = torch.stft(yp, N_FFT, HOP, window=_stft_window(y.device), center=False,
                      return_complex=True)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6)
    return torch.log(torch.clamp(fb @ mag, min=clip_val))


def mel_work(lengths: list, fb) -> tuple[float, float, float]:
    """(operations, bytes, bound ms) of one mel call at the default config,
    the mean over (1, T) calls of the given lengths. Least operations per
    frame: a real-input FFT (complex FFT of n/2 points, 2.5 (n/2) log2(n/2),
    plus its split pass, about 6 per half-bin), the magnitude (4 per bin)
    and the mel projection over the filterbank's nonzeros only (2 per
    nonzero; the Slaney triangles overlap little); bytes: the samples read
    and the log-mel written once."""
    frames = sum(t // HOP for t in lengths) / len(lengths)
    samples = sum(lengths) / len(lengths)
    f, nnz = N_FFT // 2 + 1, int((fb != 0).sum())
    flops = frames * (2.5 * (N_FFT / 2) * math.log2(N_FFT / 2) + 6 * (N_FFT // 2)
                      + 4 * f + 2 * nnz)
    nbytes = 4 * (samples + frames * fb.shape[0])
    return flops, nbytes, max(flops / PEAK_F32, nbytes / HBM) * 1e3


def timing_phase(mel_mod, flash_mod, sl: dict, errs: dict) -> list:
    from amphion_tpu_torch.ops.mel import MelConfig, _fbank

    dev = torch.device("cuda")
    cfg = MelConfig()
    g = torch.Generator(dev).manual_seed(1)
    ys = [torch.randn((1, t), generator=g, device=dev) * 0.2 for t in sl["mel_lengths"]]
    fb = _fbank(cfg, dev)
    n = len(ys)
    kernel = lambda: [mel_mod.mel_spectrogram(y, cfg) for y in ys]  # noqa: E731
    plain = lambda: [mel_mod.mel_spectrogram_ref(y, cfg) for y in ys]  # noqa: E731
    library = lambda: [library_mel(y, fb, cfg.clip_val) for y in ys]  # noqa: E731
    log(f"timing mel_spectrogram, launched from Python (gpu_ms): kernel "
        f"{gpu_ms(kernel) / n:.5f} ms, library {gpu_ms(library) / n:.5f} ms")
    # the plain version copies its DFT basis from the host at each call, which
    # a CUDA graph cannot capture: it is timed launched from Python
    mel_ms, mel_lib, mel_plain = graph_ms(kernel) / n, graph_ms(library) / n, gpu_ms(plain) / n
    lib_err = max((library_mel(y, fb, cfg.clip_val) - mel_mod.mel_spectrogram_ref(y, cfg))
                  .abs().max().item() for y in ys)
    frames = sum(y.shape[1] // HOP for y in ys) / n
    mel_flops, mel_bytes, mel_bound = mel_work([y.shape[1] for y in ys], fb)
    nnz = int((fb != 0).sum())
    log(f"timing mel_spectrogram ({nvidia_smi()}): kernel {mel_ms:.5f} ms and library "
        f"(torch.stft) {mel_lib:.5f} ms (max|diff| {lib_err:.2g}) by graph replays, plain "
        f"{mel_plain:.5f} ms launched from Python, bound "
        f"{mel_bound:.3g} ms ({mel_flops / frames:.0f} operations per frame, filterbank "
        f"nonzeros {nnz}), mean over the {n} main-path calls of (1, T), "
        f"T in {sorted(set(sl['mel_lengths']))}")

    _, (lt_tok,), lp_tok = sl["bucket"]
    b, L, h, d = len(sl["valid"]), lp_tok + lt_tok, 16, 64
    q, k, v = (torch.randn((b, L, h, d), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    valid = torch.tensor(sl["valid"], device=dev)
    mask = (torch.arange(L, device=dev)[None] < valid[:, None]).float()
    bmask = (mask > 0)[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kernel = lambda: flash_mod.flash_attention(q, k, v, mask)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bmask)  # noqa: E731
    log(f"timing flash_attn_fwd, launched from Python (gpu_ms): kernel {gpu_ms(kernel):.5f} ms, "
        f"library (SDPA) {gpu_ms(sdpa):.5f} ms")
    fl_ms, fl_lib = graph_ms(kernel), graph_ms(sdpa)
    fl_plain = graph_ms(lambda: flash_mod.attention_ref(q, k, v, mask), iters=5)
    fl_flops = 4.0 * h * d * L * float(valid.sum())  # QK^T and PV over valid keys
    fl_bytes = 4 * b * L * h * d * 2 + b * L * 4
    fl_bound = max(fl_flops / PEAK_BF16, fl_bytes / HBM) * 1e3
    log(f"timing flash_attn_fwd (graph replays, {nvidia_smi()}): kernel {fl_ms:.5f} ms "
        f"({fl_flops / fl_ms / 1e9:.1f} TFLOP/s), plain {fl_plain:.5f} ms, library (SDPA) "
        f"{fl_lib:.5f} ms, bound {fl_bound:.5f} ms at bf16 q/k/v ({b}, {L}, {h}, {d}), key mask, "
        f"valid {sl['valid']}")

    return [
        _row("mel_spectrogram", "mel.cu", 425, sl["launches"]["mel"], errs["mel"], mel_ms,
            mel_plain, mel_bound,
            "operations" if mel_flops / PEAK_F32 >= mel_bytes / HBM else "bytes", mel_lib,
            timing="graph replays (kernel, library); plain launched from Python",
            max_abs_err_vs_float64=errs["mel_f64"],
            plain_max_abs_err_vs_float64=errs["mel_plain_f64"],
            ms_is=f"mean over the {n} main-path calls of a timbre batch"),
        _row("flash_attn_fwd", "flash_attn_fwd.cu", 843, sl["launches"]["flash_attn_fwd"],
            errs["flash"], fl_ms, fl_plain, fl_bound,
            "operations" if fl_flops / PEAK_BF16 >= fl_bytes / HBM else "bytes", fl_lib,
            timing="graph replays (kernel, plain and SDPA)"),
    ]


# -- Vevo-Voice: kernels 4, 5 and 8 ----------------------------------------------

DEV = "cuda"  # the card the smoke drives
AR_LAYERS, AR_HIDDEN, AR_HEADS, AR_FFN = 24, 1280, 20, 4096  # config/vevo.json, FFN 4096
FM_LAYERS, FM_HIDDEN, FM_STEPS = 16, 1024, 32
AR_PROJ = [(AR_HIDDEN, 3 * AR_HIDDEN), (AR_HIDDEN, AR_HIDDEN), (AR_HIDDEN, 2 * AR_FFN),
           (AR_FFN, AR_HIDDEN)]  # (K, N) of qkv, o, gateup, down
PROLOGUE_PROJ = ("qkv", "gateup")  # the projections AMPHION_FUSED_RMS=1 normalises in #5
FM_QKV = (6144, FM_HIDDEN, 3 * FM_HIDDEN)  # (M, K, N): 4 * 1536 rows, a timbre-sized FM batch
DECODE_ROWS = (1, 2, 4, 8, 16)  # decode batch rows of the padding phase


def quant_kernel_phase(seed: int) -> None:
    """Kernels 4 and 5 (with and without the RMSNorm prologue) against
    their plain versions on random data, before any model is built: at the
    decode shapes (M = 4) and at a 6144-row FM projection. The voice phases
    then check both kernels on the main path's own activations and weights
    (`path_quant_check`). Tolerances there and here: both matmul paths sum
    bf16 products in float32 in another order than the plain version, so
    float32 output within 1e-4 of max|ref|; with the prologue the bf16
    rounding of the normalised x may flip, so within 2e-2 of max|ref| and a
    relative Frobenius error of 1e-3."""
    from amphion_tpu_torch.ops.kernels.int4_matmul import (
        int4_matmul, int4_matmul_ref, pack_int4, quantize_weight_int4)
    from amphion_tpu_torch.ops.kernels.int8_matmul import (
        int8_matmul, int8_matmul_ref, quantize_weight_int8)

    dev = torch.device(DEV)
    g = torch.Generator(dev).manual_seed(seed + 7)
    shapes = [(4, k, n) for k, n in AR_PROJ] + [FM_QKV]
    for m, k, n in shapes:
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        w = (torch.randn((n, k), generator=g, device=dev) * 0.03).bfloat16()
        w_q, sc = quantize_weight_int8(w)
        out, ref = int8_matmul(x, w_q, sc), int8_matmul_ref(x, w_q, sc)
        err = (out - ref).abs().max().item()
        check(f"int8_matmul M={m} K={k} N={n}", err <= 1e-4 * ref.abs().max().item(),
              f"max|err| {err:.3g}, max|ref| {ref.abs().max().item():.3g} (tol 1e-4 rel)")
        w_int, sc4 = quantize_weight_int4(w, 128)
        w_p = pack_int4(w_int)
        gain = 1 + 0.1 * torch.randn((k,), generator=g, device=dev)
        for rms in (None, gain):
            out = int4_matmul(x, w_p, sc4, 128, rms, 1e-6)
            ref = int4_matmul_ref(x, w_p, sc4, 128, rms, 1e-6)
            err = (out - ref).abs().max().item()
            scale = ref.abs().max().item()
            ok, detail = quant_close(out, ref, rms is not None)
            check(f"int4_matmul M={m} K={k} N={n} rms_prologue={rms is not None}", ok, detail)


def quant_close(out, ref, prologue: bool) -> tuple[bool, str]:
    """Kernel 4/5 float32 output against the plain version's (tolerances
    in `quant_kernel_phase`)."""
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    if not prologue:
        return err <= 1e-4 * scale, f"max|err| {err:.3g} (tol 1e-4 of {scale:.3g})"
    fro = ((out - ref).norm() / ref.norm()).item()
    return (err <= 2e-2 * scale and fro <= 1e-3,
            f"max|err| {err:.3g} (tol 2e-2 of {scale:.3g}), rel Frobenius {fro:.3g} (tol 1e-3)")


class ProjRecorder:
    """Forward pre-hooks on the quantized projections (qkv, o, gateup,
    down) of the first and last layers of the AR decoder and, unless
    ``ar_only``, of the flow-matching estimator: each keeps its first input
    (and RMSNorm gain, when the prologue runs) at every row count it sees,
    so that the kernels can be held against their plain versions on the
    activations and weights the main path gave them. Copying a few inputs
    launches no kernel of the port."""

    def __init__(self, pipe, ar_only: bool = False):
        self.seen, self.hooks = {}, []
        stacks = [("ar", pipe.ar.decoder, AR_LAYERS)]
        if not ar_only:
            stacks.append(("fm", pipe.fm.diff_estimator.encoder, FM_LAYERS))
        for tag, stack, n in stacks:
            for i in (0, n - 1):
                layer = getattr(stack, f"layer_{i}")
                for label, mod in (("qkv", layer.attn.qkv_proj), ("o", layer.attn.o_proj),
                                   ("gateup", layer.mlp.gateup_proj),
                                   ("down", layer.mlp.down_proj)):
                    self.hooks.append(mod.register_forward_pre_hook(
                        self._hook(f"{tag} layer_{i} {label}")))

    def _hook(self, name):
        def hook(mod, args):
            x = args[0].reshape(-1, args[0].shape[-1])
            rms = args[1] if len(args) > 1 else None
            key = (name, x.shape[0], rms is not None)
            if key not in self.seen:
                self.seen[key] = (mod, x.clone(), None if rms is None else rms.clone())
        return hook

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()


def path_quant_check(label: str, rec: ProjRecorder, int4: bool) -> float:
    """Kernel 4 (or 5) against its plain version on every recorded input
    of the main path, at the output dtype the path asked for: float32 within
    `quant_close`, and the bf16 output bit-equal to the float32 one rounded.
    At the GEMM's rows (M > 8) a relaunch must give the same bits. At the
    decode rows (M <= 8) the GEMV must also give the same bits when
    relaunched, and each row the same bits alone (M = 1), at the recorded
    rows and among 8 rows (the recorded ones, then the same reversed), in
    float32 and in the path's dtype. Returns the largest float32 error."""
    from amphion_tpu_torch.ops.kernels.int4_matmul import int4_matmul, int4_matmul_ref
    from amphion_tpu_torch.ops.kernels.int8_matmul import int8_matmul, int8_matmul_ref

    worst, n_gemv = 0.0, 0
    for (name, m, pro), (mod, x, rms) in sorted(rec.seen.items(), key=lambda kv: kv[0]):
        if int4:
            def run(fn, xx, dt):
                return fn(xx, mod.kernel_q, mod.scale, mod.group, rms, 1e-6, out_dtype=dt)
            kernel, plain = int4_matmul, int4_matmul_ref
        else:
            def run(fn, xx, dt):
                return fn(xx, mod.kernel_q, mod.scale, out_dtype=dt)
            kernel, plain = int8_matmul, int8_matmul_ref
        out, ref = run(kernel, x, torch.float32), run(plain, x, torch.float32)
        worst = max(worst, (out - ref).abs().max().item())
        ok, detail = quant_close(out, ref, pro)
        out_bf = run(kernel, x, x.dtype)
        same = bool(torch.equal(out_bf, out.to(x.dtype)))
        n, k = mod.kernel_q.shape[0], x.shape[1]
        if m > 8:  # the GEMM: the same bits when relaunched
            same = same and bool(torch.equal(run(kernel, x, torch.float32), out))
        check(f"{label} path {name} M={m} K={k} N={n} rms_prologue={pro}", ok and same,
              f"{detail}; {x.dtype} output equals the float32 one rounded"
              + (" and a relaunch's bits" if m > 8 else "") + f": {same}")
        if m <= 8:
            n_gemv += 1
            x8 = torch.cat([x, x.flip(0)])[:8]
            relaunch = rows = True
            for dt, first in ((torch.float32, out), (x.dtype, out_bf)):
                relaunch &= bool(torch.equal(run(kernel, x, dt), first))
                full = run(kernel, x8, dt)
                rows &= bool(torch.equal(full[:m], first)) and all(
                    torch.equal(run(kernel, x[r:r + 1], dt)[0], first[r]) for r in range(m))
            check(f"{label} path {name} M={m} rms_prologue={pro} GEMV bits", relaunch and rows,
                  f"relaunch bit-equal {relaunch}; each row alone, at M={m} and among 8 "
                  f"rows bit-equal {rows}")
    if n_gemv:
        log(f"  {label}: the GEMV's bits held on relaunch and row by row in {n_gemv} "
            "recorded projections")
    return worst


def decode_attn_check(seed: int, cache_len: int) -> float:
    """Kernel 8 against its plain version at the single-utterance cache
    (B = 1, H = 20, S = cache_len, D = 64), valid_len below S; within 1e-4
    of max|ref| (float32 sums in another order). Returns the max error."""
    from amphion_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_int8, decode_attention_int8_ref)

    dev = torch.device(DEV)
    g = torch.Generator(dev).manual_seed(seed + 8)
    worst = 0.0
    b, h, d = 1, AR_HEADS, AR_HIDDEN // AR_HEADS
    q = torch.randn((b, h, d), generator=g, device=dev)
    ck, cv = (torch.randint(-127, 128, (b, h, cache_len, d), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, h, cache_len), generator=g, device=dev) * 0.02 for _ in range(2))
    for valid in (cache_len - 311, cache_len // 2, 1):
        lens = torch.tensor([valid], device=dev, dtype=torch.int32)
        out = decode_attention_int8(q, ck, cv, ks, vs, lens)
        ref = decode_attention_int8_ref(q, ck, cv, ks, vs, lens)
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        check(f"decode_attn_int8 B={b} H={h} S={cache_len} D={d} valid_len={valid}",
              err <= 1e-4 * ref.abs().max().item(), f"max|err| {err:.3g} (tol 1e-4 rel)")
    return worst


def graph_node_types(fn, generators=()) -> list:
    """The node types (CUgraphNodeType: 0 a kernel) of the CUDA graph that
    one ``fn()`` captures, read by the driver's cuGraphGetNodes; the
    ``generators`` that ``fn`` draws from are registered with the graph."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    for gen in generators:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n))
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        types.append(t.value)
    return types


class DecodeAttnRecorder:
    """While installed, stands in for kernel 8's wrapper where the AR
    decoder calls it (`modules.llama.decode_attention_int8`): it counts the
    calls (24 a decode step, one a layer) and keeps the inputs and output of
    every layer's call at the decode steps in ``steps`` (copies: the cache
    grows in place). Copying launches no kernel of the port."""

    def __init__(self, steps):
        from amphion_tpu_torch.modules import llama

        self.mod, self.wrapped = llama, llama.decode_attention_int8
        self.steps, self.n, self.calls = set(steps), 0, {}
        llama.decode_attention_int8 = self

    def __call__(self, q, ck, cv, ks, vs, valid_len):
        out = self.wrapped(q, ck, cv, ks, vs, valid_len)
        step = self.n // AR_LAYERS
        self.n += 1
        if step in self.steps:
            self.calls.setdefault(step, []).append(
                tuple(t.clone() for t in (q, ck, cv, ks, vs, valid_len, out)))
        return out

    def remove(self) -> None:
        self.mod.decode_attention_int8 = self.wrapped


def decode_attn_path_check(rec: DecodeAttnRecorder) -> dict:
    """Kernel 8 on what the fused run gave it: each recorded call's own
    output within 1e-4 of max|ref| of `decode_attention_int8_ref` on its
    inputs, and a relaunch on them bit-equal to it; one call captured in a
    CUDA graph must be one kernel node. Returns the largest errors."""
    from amphion_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_int8, decode_attention_int8_ref)

    worst, worst_rel, n = 0.0, 0.0, 0
    lens = {}
    for step, calls in sorted(rec.calls.items()):
        check(f"decode_attn_int8 on the path: step {step} recorded in every layer",
              len(calls) == AR_LAYERS, f"{len(calls)} calls (want {AR_LAYERS})")
        lens[step] = int(calls[0][5][0])
        for layer, (*args, out) in enumerate(calls):
            ref = decode_attention_int8_ref(*args)
            err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
            same = torch.equal(decode_attention_int8(*args), out)
            if not (err <= 1e-4 * scale and same):
                check(f"decode_attn_int8 on the path: step {step} layer {layer} valid_len "
                      f"{lens[step]}", False, f"max|err| {err:.3g} (tol 1e-4 of {scale:.3g}), "
                      f"relaunch bit-equal {same}")
            worst, worst_rel, n = max(worst, err), max(worst_rel, err / scale), n + 1
    check("decode_attn_int8 on the path: every recorded call against its plain version",
          n > 0, f"{n} calls at steps {sorted(lens)} (valid_len {sorted(lens.values())}), "
          f"max|err| {worst:.3g}, at most {worst_rel:.3g} of max|ref| (tol 1e-4), each "
          "relaunch bit-equal")
    args = rec.calls[max(rec.calls)][0][:6]
    types = graph_node_types(lambda: decode_attention_int8(*args))
    check("decode_attn_int8: one CUDA kernel per call", types == [0],
          f"one call captured in a CUDA graph gives nodes of types {types} (0: a kernel)")
    return {"max_abs_err": worst, "max_rel_err": worst_rel}


def ar_reference_phase(seed: int) -> None:
    """A small float32 AR decoded greedily on the card and on the CPU."""
    import copy

    from amphion_tpu_torch.models.vc.ar_transformer import (
        ARTransformer, ARTransformerConfig, ar_transformer_generate)

    torch.manual_seed(seed)
    cpu = ARTransformer(ARTransformerConfig(input_vocab=32, output_vocab=256, hidden=128,
                                            intermediate=256, num_layers=2, num_heads=4,
                                            max_position=512)).eval()
    gpu = copy.deepcopy(cpu).to(DEV)
    rng = np.random.default_rng(seed + 3)
    inp = torch.from_numpy(rng.integers(0, 32, (2, 40)))
    pout = torch.from_numpy(rng.integers(0, 256, (2, 12)))
    outs = [ar_transformer_generate(m, inp, None, max_new=48, temperature=0.0,
                                    prompt_output_tokens=pout, compute_dtype="float32")[0].cpu()
            for m in (gpu, cpu)]
    agree = (outs[0] == outs[1]).float().mean().item()
    check("reference: small f32 AR, greedy, card vs CPU", agree == 1.0,
          f"tokens equal {agree:.4f} (tol: all)")


class ARRecorder:
    """Wraps the service's ragged AR decode and keeps each batch's inputs
    and outputs, so the smoke can read the generated tokens."""

    def __init__(self, service_mod):
        self.mod, self.inner, self.calls = service_mod, service_mod.ar_transformer_generate_ragged, []
        service_mod.ar_transformer_generate_ragged = self

    def __call__(self, model, input_tokens, input_len, *a, **kw):
        toks, n = self.inner(model, input_tokens, input_len, *a, **kw)
        self.calls.append((input_tokens.cpu(), input_len.cpu(),
                           kw["prompt_output_tokens"].cpu(), kw["prompt_output_len"].cpu(),
                           toks.cpu(), n.cpu()))
        return toks, n

    def row_of(self, call, req):
        """(tokens, length) of the row that holds ``req``'s content and style
        prompt in recorded call ``call``."""
        inp, ln, pout, plen, toks, n = self.calls[call]

        def same(buf, lens, i, want):
            return int(lens[i]) == len(want) and bool((buf[i, : len(want)] == want.cpu()).all())

        for i in range(inp.shape[0]):
            if same(inp, ln, i, req.content) and same(pout, plen, i, req.prompt_out):
                return toks[i], int(n[i])
        raise SystemExit("voice: a request was not in the recorded batch")


def pick_voice_audio(svc, rng) -> list:
    """Four (reference, source) pairs of 2-3 s whose voice buckets (content,
    style prompt, FM prompt) agree, found among random candidates."""
    groups = {}
    for _ in range(32):
        pair = (synth_audio(rng, float(rng.choice([2.5, 3.0]))),
                synth_audio(rng, float(rng.choice([2.0, 2.5, 3.0]))))
        req = svc._prepare_request(pair[1], pair[0], "voice", 0)
        groups.setdefault(svc._bucket_of(req), []).append((pair, len(req.content)))
        best = max(groups.values(), key=len)
        if len(best) >= 4:
            break
    best = max(groups.values(), key=len)
    if len(best) < 4:
        raise SystemExit(f"voice: no four candidates share a bucket: {[len(v) for v in groups.values()]}")
    return [p for p, _ in best[:4]]


def voice_launches(max_new: int) -> int:
    """Quantized-matmul launches of one voice batch: 4 projections per
    layer in the AR prefill and in each of max_new decode steps, and in each
    flow-matching step (one estimator pass, no CFG)."""
    return AR_LAYERS * 4 + max_new * AR_LAYERS * 4 + FM_STEPS * FM_LAYERS * 4


# GEMM launches (M > 8) of one voice batch: the AR prefill's and the flow
# matching's projections; the decode's run the GEMV (M = max_batch = 4).
VOICE_GEMM_LAUNCHES = AR_LAYERS * 4 + FM_STEPS * FM_LAYERS * 4  # 2 144


def voice_phase(cfg, seed: int, dtype: str, audio: list | None, max_new: int,
                kernels: dict, solo_check: bool) -> dict:
    """Four concurrent full-width Vevo-Voice requests in ``dtype``."""
    from amphion_tpu_torch.pipelines.vevo_pipeline import build_vevo_voice
    from amphion_tpu_torch.serving import service as service_mod

    t0 = time.perf_counter()
    pipe = build_vevo_voice(cfg, seed, DEV, compute_dtype=dtype)
    log(f"voice {dtype}: built full-width Vevo-Voice (AR {AR_HIDDEN}x{AR_LAYERS}, "
        f"{AR_HEADS} heads, FFN {AR_FFN}, kv_quant {pipe.ar.cfg.kv_quant}; FM "
        f"{FM_HIDDEN}x{FM_LAYERS}) in {time.perf_counter() - t0:.1f} s")
    svc = service_mod.VevoService(pipe, max_batch=4, max_wait_ms=3000, len_step=64,
                                  max_new=max_new, temperature=1.0, top_k=40)
    rec = ARRecorder(service_mod)
    qk = kernels["int8_matmul" if dtype == "int8" else "int4_matmul"]
    try:
        if audio is None:
            audio = pick_voice_audio(svc, np.random.default_rng(seed + 11))
        seeds = [seed * 100 + 50 + i for i in range(len(audio))]
        reqs = [svc._prepare_request(s_, r, "voice", sd) for (r, s_), sd in zip(audio, seeds)]
        bucket = svc._bucket_of(reqs[0])
        log(f"voice {dtype}: bucket {bucket}; content {[len(r.content) for r in reqs]}, "
            f"style prompt {[len(r.prompt_out) for r in reqs]}, FM prompt "
            f"{[len(r.fm_prompt_tokens) for r in reqs]} tokens")
        if solo_check:
            t0 = time.perf_counter()
            solo = svc.batcher.submit(reqs[0]).result(timeout=900)
            torch.cuda.synchronize()
            log(f"voice {dtype}: request 0 alone (cold) in {time.perf_counter() - t0:.2f} s")
        prec = ProjRecorder(pipe)
        for k in kernels.values():
            k.reset()
        batches0 = svc.stats()["batches"]
        torch.cuda.reset_peak_memory_stats()
        wavs, lats, wall = serve(svc, audio, seeds, "voice")
        launches = {name: k.launches for name, k in kernels.items()}
        gemm_launches = qk.tagged.get("gemm", 0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        prec.remove()
        n_batches = svc.stats()["batches"] - batches0
        log(f"voice {dtype}: launches {launches} over {n_batches} batch(es)")
        check(f"voice {dtype} one batch", n_batches == 1, f"{n_batches} batch(es)")
        want = voice_launches(max_new)
        check(f"voice {dtype} {qk.name} launches", launches[qk.name] == want,
              f"{launches[qk.name]} (predicted {AR_LAYERS}*4 + {max_new}*{AR_LAYERS}*4 + "
              f"{FM_STEPS}*{FM_LAYERS}*4 = {want})")
        check(f"voice {dtype} {qk.name} GEMM launches", gemm_launches == VOICE_GEMM_LAUNCHES,
              f"{gemm_launches} (predicted the AR prefill's {AR_LAYERS}*4 + the flow "
              f"matching's {FM_STEPS}*{FM_LAYERS}*4 = {VOICE_GEMM_LAUNCHES}; the decode's "
              f"{max_new}*{AR_LAYERS}*4 run the GEMV)")
        other = "int4_matmul" if dtype == "int8" else "int8_matmul"
        check(f"voice {dtype} mel/flash/other launches",
              launches["mel"] == 3 * len(audio) and launches["flash_attn_fwd"] == FM_LAYERS * FM_STEPS
              and launches[other] == 0 and launches["decode_attn_int8"] == 0,
              f"mel {launches['mel']} (3 per request), flash {launches['flash_attn_fwd']} "
              f"({FM_LAYERS}x{FM_STEPS}), {other} {launches[other]}, decode_attn 0 "
              "(the ragged step passes a key mask)")
        norms = 2 * AR_LAYERS + 1
        check(f"voice {dtype} rms_norm/bf16_gemv launches",
              launches["rms_norm"] == norms * (1 + max_new)
              and launches["bf16_gemv"] == 1 + max_new,
              f"rms_norm {launches['rms_norm']} (predicted {norms} norms x (the prefill + "
              f"{max_new} steps) = {norms * (1 + max_new)}), bf16_gemv {launches['bf16_gemv']} "
              f"(predicted the lm_head of the prefill and of each step, {1 + max_new})")
        gen = []
        for i, (r, w) in enumerate(zip(reqs, wavs)):
            toks, n = rec.row_of(-1, r)
            gen.append(n)
            want_len = max(n, 1) * HOP
            check(f"voice {dtype} request {i} waveform",
                  w.shape == (want_len,) and np.isfinite(w).all() and np.abs(w).max() > 0,
                  f"{w.shape[0]} samples for {n} generated tokens (want {want_len}), finite")
        if solo_check:
            solo_toks, solo_n = rec.row_of(0, reqs[0])
            batch_toks, batch_n = rec.row_of(-1, reqs[0])
            same = int((solo_toks == batch_toks).sum())
            check(f"voice {dtype} batch invariance: tokens",
                  same == max_new and solo_n == batch_n,
                  f"request 0 alone vs in the batch: {same}/{max_new} tokens equal, lengths "
                  f"{solo_n}/{batch_n}")
            diff = np.abs(wavs[0] - solo).max() / np.abs(solo).max()
            check(f"voice {dtype} batch invariance: waveform", diff <= 3e-2,
                  f"max|diff|/max|solo| {diff:.3g} (tol 3e-2)")
        audio_out = sum(len(w) for w in wavs) / SR
        perf = {"requests": len(wavs), "batch_wall_s": wall, "latency_s": lats,
                "generated_tokens": gen, "audio_s_out": audio_out,
                "audio_s_per_s": audio_out / wall, "max_memory_allocated_gib": peak,
                "decode_steps_per_s": max_new / wall}
        log(f"voice {dtype} perf: " + json.dumps(perf))
        _, (lc, lo), lp_tok = bucket
        lt_tok = svc._ladder(max(max(n, 1) for n in gen), max_new)
        shapes = {"ar_prefill_rows": svc.batcher.max_batch * (lc + 3 + lo),
                  "fm_rows": len(audio) * (lp_tok + lt_tok)}
        rows_seen = sorted({m for _, m, _ in prec.seen})
        check(f"voice {dtype} recorded projection rows", rows_seen == sorted(
              {4, shapes["ar_prefill_rows"], shapes["fm_rows"]}),
              f"{rows_seen} (decode 4, AR prefill {shapes['ar_prefill_rows']}, FM "
              f"{shapes['fm_rows']})")
        path_err = path_quant_check(f"voice {dtype}", prec, dtype == "int4")
        del prec
    finally:
        svc.shutdown()
        service_mod.ar_transformer_generate_ragged = rec.inner
    return {"pipe": pipe, "audio": audio, "launches": launches, "gemm_launches": gemm_launches,
            "perf": perf,
            "shapes": shapes, "path_err": path_err, "seeds": seeds,
            "ar_inputs": rec.calls[-1][:4]}


def fused_phase(v8: dict, v4: dict, seed: int, max_new: int, kernels: dict) -> dict:
    """Kernel 8 on a single-utterance int8 run with
    AMPHION_FUSED_DECODE_ATTN=1, and kernel 5's RMSNorm prologue on an int4
    decode with AMPHION_FUSED_RMS=1."""
    from amphion_tpu_torch.models.vc.ar_transformer import ar_transformer_generate_ragged
    from amphion_tpu_torch.serving.service import voice_generators

    pipe = v8["pipe"]
    ref, src = v8["audio"][0]
    content = pipe.content_tokens(torch.cat([pipe.audio(ref), pipe.audio(src)]))
    prompt = pipe.ar_style_prompt(ref)
    cache_len = len(content) + 3 + prompt.shape[1] + max_new
    attn_err = decode_attn_check(seed, cache_len)
    # kernel 8's calls at the first, every 128th and the last decode step,
    # all 24 layers each
    rec = DecodeAttnRecorder(sorted({0, *range(128, max_new, 128), max_new - 1}))
    for k in kernels.values():
        k.reset()
    os.environ["AMPHION_FUSED_DECODE_ATTN"] = "1"
    try:
        g_ar, g_fm = voice_generators(seed, DEV)
        t0 = time.perf_counter()
        wav = pipe.inference_ar_and_fm(src, ref, ref, g_ar, g_fm, max_new=max_new,
                                       temperature=1.0, top_k=40)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del os.environ["AMPHION_FUSED_DECODE_ATTN"]
        rec.remove()
    n_attn, n8 = kernels["decode_attn_int8"].launches, kernels["int8_matmul"].launches
    check("fused decode attention launches", n_attn == AR_LAYERS * max_new,
          f"{n_attn} (predicted {AR_LAYERS} layers x {max_new} steps), int8_matmul {n8} "
          f"(predicted {voice_launches(max_new)})")
    check("fused decode attention output", n8 == voice_launches(max_new)
          and bool(torch.isfinite(wav).all()) and wav.ndim == 1 and len(wav) % HOP == 0,
          f"{len(wav)} samples, finite, single utterance in {wall:.2f} s, cache {cache_len}")
    attn_path = decode_attn_path_check(rec)
    attn_inputs = {step: [c[:6] for c in calls] for step, calls in rec.calls.items()}
    del rec

    # the int4 voice batch's own AR decode (its four requests' buffers),
    # 64 steps, with the RMSNorm in the qkv and gateup matmuls' prologue
    pipe4 = v4["pipe"]
    steps = 64
    inp, ln, pout, plen = (t.to(DEV) for t in v4["ar_inputs"])
    gens = [voice_generators(sd, DEV)[0] for sd in v4["seeds"]]
    prec = ProjRecorder(pipe4, ar_only=True)
    for k in kernels.values():
        k.reset()
    os.environ["AMPHION_FUSED_RMS"] = "1"
    try:
        toks, n = ar_transformer_generate_ragged(
            pipe4.ar, inp, ln, gens, max_new=steps, temperature=1.0, top_k=40,
            prompt_output_tokens=pout, prompt_output_len=plen, compute_dtype="int4")
        torch.cuda.synchronize()
    finally:
        del os.environ["AMPHION_FUSED_RMS"]
        prec.remove()
    k4 = kernels["int4_matmul"]
    pro, gemm = k4.tagged.get("rms_prologue", 0), k4.tagged.get("gemm", 0)
    check("fused RMSNorm prologue launches", pro == 2 * AR_LAYERS * (1 + steps)
          and k4.launches == 4 * AR_LAYERS * (1 + steps) and gemm == 4 * AR_LAYERS
          and bool((toks >= 0).all()),
          f"{pro} prologue launches of {k4.launches}, {gemm} on the GEMM path (predicted 2 x "
          f"{AR_LAYERS} layers x (prefill + {steps} steps) of 4 x ..., the prefill's 4 x "
          f"{AR_LAYERS} on the GEMM)")
    pro_rows = sorted({m for _, m, p in prec.seen if p})
    check("fused RMSNorm prologue rows", pro_rows == [len(gens), v4["shapes"]["ar_prefill_rows"]],
          f"{pro_rows} (decode {len(gens)}, the voice batch's AR prefill "
          f"{v4['shapes']['ar_prefill_rows']})")
    pro_err = path_quant_check("int4 fused RMSNorm", prec, True)
    return {"cache_len": cache_len, "prompt_len": cache_len - max_new, "fused_wall_s": wall,
            "attn_launches": n_attn, "prologue_launches": pro, "attn_err": attn_err,
            "attn_path": attn_path, "attn_inputs": attn_inputs, "prologue_err": pro_err}


class RowAloneCheck(TorchDispatchMode):
    """Runs each PyTorch operation of a batch of ``b`` rows a second time on
    row 0 alone (every input whose first dimension is ``b`` cut to its first
    row) and compares row 0 of the two results bit for bit, counting the
    operations whose bits differ by operation and call site. Skips
    operations that write to their inputs or draw random numbers, and those
    whose result or inputs do not lead with the batch, and the allocations
    whose bits are not set (``empty_like``). The port's own CUDA kernels run
    outside PyTorch's dispatcher and are not seen here."""

    UNSET = ("aten::empty", "aten::empty_like", "aten::new_empty", "aten::empty_strided",
             "aten::new_empty_strided")

    def __init__(self, b: int):
        super().__init__()
        self.b, self.ops, self.checked, self.differ = b, 0, 0, {}

    def _site(self) -> str:
        for f in reversed(traceback.extract_stack()):
            if "amphion_tpu_torch" in f.filename:
                return f"{f.filename[f.filename.rindex('amphion_tpu_torch'):]}:{f.lineno}"
        return "?"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if (func._schema.is_mutable or torch.Tag.nondeterministic_seeded in func.tags
                or func._schema.name in self.UNSET or not isinstance(out, torch.Tensor)
                or out.dim() == 0 or out.shape[0] != self.b):
            return out
        flat, spec = tree_flatten((args, kwargs))
        cut = [isinstance(a, torch.Tensor) and a.dim() > 0 and a.shape[0] == self.b
               for a in flat]
        if not any(cut):
            return out
        a1, k1 = tree_unflatten([a[:1] if c else a for a, c in zip(flat, cut)], spec)
        try:
            one = func(*a1, **k1)
        except (RuntimeError, IndexError, ValueError, TypeError):
            return out  # an operation whose arguments name the batch size
        if not isinstance(one, torch.Tensor) or one.shape != (1, *out.shape[1:]):
            return out
        self.checked += 1
        if not torch.equal(one.contiguous().view(torch.uint8),
                           out[:1].contiguous().view(torch.uint8)):
            key = f"{func} at {self._site()}"
            self.differ[key] = self.differ.get(key, 0) + 1
        return out


def padding_phase(v8: dict) -> dict:
    """What an eager int8 decode costs per step at 1-16 rows (what padding
    to ``max_batch`` rows cost the window service, and still costs it under
    float32/bf16), and that row 0 no longer depends on the row count.
    Decodes the int8 voice batch's requests (row 0 is request 0, rows past
    the fourth repeat it) at each row count of DECODE_ROWS: wall and device
    time per decode step, each the difference of a 72-step and an 8-step
    decode (the prefill cancels), the device time from a profiled rerun;
    and row 0's tokens, which must agree at every row count. Then one
    prefill and two steps at 4 rows under `RowAloneCheck`: no PyTorch
    operation may change row 0's bits when row 0 runs alone."""
    from torch.profiler import ProfilerActivity, profile

    from amphion_tpu_torch.models.vc.ar_transformer import ar_transformer_generate_ragged
    from amphion_tpu_torch.serving.service import voice_generators

    ar, inputs, seeds = v8["pipe"].ar, v8["ar_inputs"], v8["seeds"]

    def decode(rows: int, steps: int):
        idx = [i if i < len(seeds) else 0 for i in range(rows)]
        inp, ln, pout, plen = (t[idx].to(DEV) for t in inputs)
        gens = [voice_generators(seeds[i], DEV)[0] for i in idx]
        toks, _ = ar_transformer_generate_ragged(
            ar, inp, ln, gens, max_new=steps, temperature=1.0, top_k=40,
            prompt_output_tokens=pout, prompt_output_len=plen, compute_dtype="int8")
        torch.cuda.synchronize()
        return toks

    s1, s2 = 8, 72
    cost, row0 = {}, {}
    for rows in DECODE_ROWS:
        wall, busy = {}, {}
        for steps in (s1, s2):
            t0 = time.perf_counter()
            toks = decode(rows, steps)
            wall[steps] = time.perf_counter() - t0
        row0[rows] = toks[0].cpu()
        for steps in (s1, s2):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                decode(rows, steps)
            busy[steps] = sum(device_us_by_name(prof)[0].values()) / 1e3
        cost[rows] = {"wall_ms_per_step": (wall[s2] - wall[s1]) / (s2 - s1) * 1e3,
                      "device_ms_per_step": (busy[s2] - busy[s1]) / (s2 - s1)}
    agree = {f"{a}/{b} rows": int((row0[a] == row0[b]).sum())
             for a, b in zip(DECODE_ROWS, DECODE_ROWS[1:])}
    log("voice padding cost (int8 decode, per step): " + json.dumps(cost))
    gemv_rows = [f"{a}/{b} rows" for a, b in zip(DECODE_ROWS, DECODE_ROWS[1:]) if b <= 8]
    check("voice int8 decode: row 0's tokens at every row count up to 8",
          all(agree[k] == s2 for k in gemv_rows),
          f"{s2} tokens equal between row counts: " + json.dumps(agree) + " (past 8 rows the "
          "projections take the GEMM path, whose rows differ from the GEMV's bits)")
    with RowAloneCheck(4) as mode:
        decode(4, 2)
    check("voice int8 decode: PyTorch operations row-invariant", not mode.differ,
          f"{mode.checked} of {mode.ops} PyTorch operations of a prefill and two steps at "
          f"4 rows rerun on row 0 alone; row 0's bits differ in: " + json.dumps(mode.differ))
    return {"cost": cost, "row0_tokens_equal": agree, "differ": mode.differ}


# -- the continuous engine: row invariance, CUDA graphs, the serve CLI -------------

ENGINE_SLOTS, ENGINE_CHUNK, ENGINE_STEP = 4, 64, 64  # bins/serve.py: --slots, --chunk, --len_step
# the staggered engine runs of the voice pipeline (graph engine, eager engine
# and four solo decodes a dtype): cut below --max-new for the run's time
ENGINE_MAX_NEW = 128
INVARIANT_ROWS = (1, 2, 4, 8)
ENGINE_GROUPS = [("int8_gemv", ("gemv_kernel", "::Int8,")),
                 ("int4_gemv", ("gemv_kernel", "::Int4,")),
                 ("bf16_gemv", ("gemv_kernel", "::Bf16,")), ("rms_norm", ("rms_norm_kernel",))]


def voice_requests(v: dict) -> list:
    """(content, AR seed, style prompt) of the voice batch's four requests,
    from its recorded AR inputs; the AR seed is the window service's
    (``2 * seed + 1``)."""
    inp, ln, pout, plen = v["ar_inputs"]
    return [(inp[i, :int(ln[i])], 2 * sd + 1, pout[i, :int(plen[i])])
            for i, sd in enumerate(v["seeds"])]


def row_invariance_phase(v: dict, dtype: str, max_new: int) -> None:
    """On the voice batch's recorded AR inputs (its four requests, repeated
    to 8 rows) and at its cache length, every row's logits after the
    prefill and after each of three decode steps are bit-equal at 1, 2, 4
    and 8 rows: the prefill runs at each row count, the steps on each
    count's own caches, with the 8-row run's sampled tokens."""
    from amphion_tpu_torch.ops.ragged import right_pack_valid
    from amphion_tpu_torch.ops.sampling import sample_logits

    ar = v["pipe"].ar
    idx = [i % 4 for i in range(max(INVARIANT_ROWS))]
    inp, ln, pout, plen = (t[idx].to(DEV) for t in v["ar_inputs"])
    l0 = inp.shape[1] + 3 + pout.shape[1]
    total = l0 + max_new
    with torch.inference_mode():
        runs = {}
        for b in INVARIANT_ROWS:
            kv = right_pack_valid([ln[:b] + 2, plen[:b] + 1], l0, total)
            caches = ar.decoder.init_cache(b, total, torch.bfloat16, DEV)
            logits, caches, _ = ar.prefill_ragged(inp[:b], ln[:b], caches, kv, pout[:b],
                                                  plen[:b])
            runs[b] = (logits, caches, kv)
        logits, caches, kv = runs[len(idx)]
        gens = [torch.Generator(DEV).manual_seed(i) for i in range(len(idx))]
        toks, full = [], [logits]
        for i in range(3):
            toks.append(sample_logits(full[-1].float(), gens, 1.0, 40))
            full.append(ar.step(toks[-1], caches, l0 + i, kv)[0])
        same = {}
        for b in INVARIANT_ROWS[:-1]:
            logits, caches, kv = runs[b]
            ok = [torch.equal(logits, full[0][:b])]
            for i in range(3):
                logits, _ = ar.step(toks[i][:b], caches, l0 + i, kv)
                ok.append(torch.equal(logits, full[1 + i][:b]))
            same[b] = ok
        torch.cuda.synchronize()
    check(f"voice {dtype} decode: every row's logits bit-equal at {INVARIANT_ROWS} rows",
          all(all(ok) for ok in same.values()),
          "prefill and three steps on the voice batch's recorded inputs, rows of each count "
          f"against the same rows of the 8-row run: {json.dumps(same)}")


def engine_phase(v: dict, dtype: str, max_new: int, kernels: dict) -> dict:
    """The continuous engine at full width on the voice pipeline (slots 4,
    chunk 64, the CLI's buckets, top-k 40): the four voice requests admitted
    staggered, one at each of the first four chunk boundaries, through the
    graph engine (a service's own, its driver stopped) and an eager engine;
    each request's tokens equal its solo one-shot decode
    (`VevoContinuousService.solo_tokens`) and the graph engine's equal the
    eager one's. Reports the graphs (nodes per rung against the eager
    step's launches, capture time), steps/s and latency of both, and a
    profiled chunk at 4 rows (device-busy share, time by group)."""
    from torch.profiler import ProfilerActivity, profile

    from amphion_tpu_torch.serving.continuous import ContinuousARBatcher
    from amphion_tpu_torch.serving.continuous_service import VevoContinuousService

    pipe = v["pipe"]
    reqs = voice_requests(v)
    t0 = time.perf_counter()
    svc = VevoContinuousService(pipe, slots=ENGINE_SLOTS, chunk=ENGINE_CHUNK,
                                len_step=ENGINE_STEP, max_new=max_new, temperature=1.0,
                                top_k=40)
    build_s = time.perf_counter() - t0
    svc.driver.shutdown()  # the engine is driven chunk by chunk from here
    eng = svc.driver.engine
    kw = dict(slots=ENGINE_SLOTS, chunk=ENGINE_CHUNK, buckets=eng.buckets,
              out_buckets=eng.out_buckets, max_new=max_new, temperature=1.0, top_k=40,
              compute_dtype=dtype)
    eager = ContinuousARBatcher(pipe.ar, graphs=False, **kw)
    # the graphs: node types of a fresh capture of each rung's step on the
    # idle eager engine, and the eager step's launches, counted by the profiler
    nodes = {}
    with torch.inference_mode():  # the engine's buffers are inference tensors
        for r in eager.rungs:
            types = graph_node_types(lambda: eager._step(r), eager.gens[:r])
            nodes[r] = {"nodes": len(types), "kernel_nodes": types.count(0),
                        "port_kernels": eng.step_launches(r)}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eager._step(ENGINE_SLOTS)
            torch.cuda.synchronize()
        eager.step_idx.zero_()
    eager_launches = device_us_by_name(prof)[1]
    facts = {"capacity": eng.capacity, "rungs": nodes, "capture_s": eng.capture_s,
             "service_build_s": build_s, "eager_step_device_records": eager_launches}
    log(f"engine {dtype} graphs (nodes per rung's step; the eager step's device records "
        "by the profiler): " + json.dumps(facts))

    def staggered(e):
        rids, t0 = [], time.perf_counter()
        for content, seed, po in reqs:
            rids.append(e.submit(content, seed, prompt_output=po))
            e.step_chunk()
        done = e.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return [done[r] for r in rids], [e.latency_s[r] for r in rids], wall

    for k in kernels.values():
        k.reset()
    chunks0 = eng.chunks
    toks_g, lat_g, wall_g = staggered(eng)
    launches = {name: k.launches for name, k in kernels.items()}
    steps_g = (eng.chunks - chunks0) * ENGINE_CHUNK
    chunks0 = eager.chunks
    toks_e, lat_e, wall_e = staggered(eager)
    steps_e = (eager.chunks - chunks0) * ENGINE_CHUNK
    t0 = time.perf_counter()
    solo = [svc.solo_tokens(content, seed, po) for content, seed, po in reqs]
    solo_s = (time.perf_counter() - t0) / len(reqs)
    same_e = [torch.equal(a, b) for a, b in zip(toks_g, toks_e)]
    same_s = [torch.equal(a, b) for a, b in zip(toks_g, solo)]
    lens = [len(t) for t in toks_g]
    check(f"engine {dtype}: graph engine tokens equal the eager engine's", all(same_e),
          f"{same_e}, lengths {lens} of {max_new}")
    check(f"engine {dtype}: each staggered request's tokens equal its solo decode", all(same_s),
          f"{same_s}, solo lengths {[len(t) for t in solo]}")
    gemv = "int8_matmul" if dtype == "int8" else "int4_matmul"
    check(f"engine {dtype}: the graphs' launches counted at their replays",
          launches["bf16_gemv"] >= steps_g and launches["rms_norm"] >= 49 * steps_g
          and launches[gemv] >= 96 * steps_g and launches["decode_attn_int8"] == 0,
          f"{json.dumps(launches)} over {steps_g} steps (at least 1, 49 and 96 a step; "
          "decode attention off the engine's path)")

    def profiled_chunk(e):
        """One chunk at 4 rows under the profiler (device activity)."""
        for content, seed, po in reqs:
            e.submit(content, seed, max_new=3 * ENGINE_CHUNK, prompt_output=po)
        e.step_chunk()  # admissions and a first chunk
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            e.step_chunk()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = e.last_rung
        e.run()
        by_name, n_rec = device_us_by_name(prof)
        groups = dict.fromkeys([g for g, _ in ENGINE_GROUPS] + ["gemm", "other"], 0.0)
        for name, us in by_name.items():
            grp = next((g for g, pats in ENGINE_GROUPS if all(p in name for p in pats)), None)
            if grp is None:
                grp = "gemm" if any(t in name for t in LIBRARY_GEMM) else "other"
            groups[grp] += us / 1e3
        busy = sum(groups.values()) / 1e3
        return {"rows": rows, "wall_s": wall, "device_busy_s": busy,
                "device_busy_share": busy / wall, "device_records": n_rec,
                "ms_per_step": wall / ENGINE_CHUNK * 1e3, "device_ms_by_group": groups}

    perf = {"decode_steps": steps_g, "graph_wall_s": wall_g, "graph_steps_per_s": steps_g / wall_g,
            "eager_wall_s": wall_e, "eager_steps_per_s": steps_e / wall_e,
            "tokens_per_s_graph": sum(lens) / wall_g, "latency_s_graph": lat_g,
            "latency_s_eager": lat_e, "solo_decode_s": solo_s,
            "profiled_chunk_graph": profiled_chunk(eng),
            "profiled_chunk_eager": profiled_chunk(eager),
            "window_batch_steps_per_s": v["perf"]["decode_steps_per_s"],
            "window_batch_wall_s": v["perf"]["batch_wall_s"]}
    log(f"engine {dtype} perf ({nvidia_smi()}): " + json.dumps(perf))
    return {"svc": svc, "perf": perf, "facts": facts, "launches": launches}


def bf16_engine_phase(cfg, seed: int, v8: dict, max_new: int) -> dict:
    """The same weights decoding in bf16 (cuBLAS products, no row-invariance
    promise): request 0 alone through the graph engine, then with the three
    others; reports how many of its tokens agree (no gate)."""
    from amphion_tpu_torch.pipelines.vevo_pipeline import build_vevo_voice
    from amphion_tpu_torch.serving.continuous import ContinuousARBatcher
    from amphion_tpu_torch.serving.continuous_service import _ladder_tuple

    ar = build_vevo_voice(cfg, seed, DEV, compute_dtype="bfloat16").ar
    eng = ContinuousARBatcher(ar, slots=ENGINE_SLOTS, chunk=ENGINE_CHUNK,
                              buckets=_ladder_tuple(ENGINE_STEP, 1024),
                              out_buckets=_ladder_tuple(ENGINE_STEP, 512), max_new=max_new,
                              temperature=1.0, top_k=40, compute_dtype="bfloat16")
    reqs = voice_requests(v8)
    alone = eng.submit(*reqs[0][:2], prompt_output=reqs[0][2])
    alone = eng.run()[alone]
    rids = [eng.submit(c, s, prompt_output=po) for c, s, po in reqs]
    together = eng.run()[rids[0]]
    n = min(len(alone), len(together))
    agree = int((alone[:n] == together[:n]).sum())
    out = {"tokens_equal": agree, "of": max_new, "lengths": [len(alone), len(together)]}
    log("engine bfloat16 (cuBLAS products): request 0 alone against 4 rows: " + json.dumps(out))
    del eng, ar
    return out


def http_phase(cfg, seed: int, dtype: str, max_new: int, kernels: dict, audio: list) -> dict:
    """`bins/serve.py` as a user starts it: full-width FM and AR trainer
    checkpoints (the voice pipeline's weights from ``seed``) under a
    temporary log_dir, `_build_vevo_service` (continuous batcher, voice,
    ``dtype``), `prewarm`, and `serve` on 127.0.0.1 at a port the OS
    picks, driven by `serving/loadgen.py` with six voice requests on a
    Poisson trace. Every response must be a 24 kHz PCM16 wav of 120 samples
    per generated token; `/api/stats` the continuous engine's."""
    import base64
    import io
    import tempfile
    import types
    import urllib.request
    import wave

    from amphion_tpu_torch.bins import serve as serve_cli
    from amphion_tpu_torch.pipelines.vevo_pipeline import vevo_modules
    from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
    from amphion_tpu_torch.serving import loadgen

    with tempfile.TemporaryDirectory(prefix="serve_") as root:
        path = os.path.join(root, "vevo.json")
        with open(path, "w") as f:
            json.dump({"base_config": os.path.abspath("config/vevo.json"),
                       "log_dir": os.path.join(root, "ckpts"), "model": cfg["model"]}, f)
        t0 = time.perf_counter()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            mods = vevo_modules(cfg, voice=True)
        for name in ("fm", "ar"):
            state = types.SimpleNamespace(
                state_dict=lambda m=mods[name]: {"model": m.state_dict()})
            ckpt_dir = os.path.join(root, "ckpts", name, "checkpoint")
            CheckpointManager(ckpt_dir).save(state, 0, 0, 0.0)
        del mods
        ckpt_s = time.perf_counter() - t0
        args = serve_cli.parse_args([
            "--backend", "vevo", "--vevo_mode", "voice", "--config", path, "--fm_exp", "fm",
            "--ar_exp", "ar", "--compute_dtype", dtype, "--max_new", str(max_new), "--port", "0",
            "--device", DEV])
        t0 = time.perf_counter()
        backend = serve_cli._build_vevo_service(args)
        build_s = time.perf_counter() - t0
    svc = backend.stats.__self__
    ntok = {}
    inner = svc.driver.submit_wait

    def recording(content, seed, **kw):  # each request's token count, by its AR seed
        toks = inner(content, seed, **kw)
        ntok[(seed - 1) // 2] = len(toks)
        return toks

    svc.driver.submit_wait = recording
    try:
        t0 = time.perf_counter()
        backend.prewarm()
        prewarm_s = time.perf_counter() - t0
        httpd = serve_cli.serve(backend.synth, backend.stats, "vevo", port=0,
                                input_sr=backend.sample_rate)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        pairs = audio + [(synth_audio(np.random.default_rng(seed + 40 + i), 2.5),
                          synth_audio(np.random.default_rng(seed + 50 + i), 3.0))
                         for i in range(2)]

        def wav64(x):
            return base64.b64encode(serve_cli._encode_wav_bytes(x, SR)).decode()

        def make_request(i):
            ref, src = pairs[i]
            return {"prompt_wav": wav64(ref), "src_wav": wav64(src), "seed": 900 + i}

        replies = {}
        submit = loadgen.http_synthesize_submit(url, timeout_s=600)

        def keep(payload):
            replies[payload["seed"]] = submit(payload)

        ntok.clear()
        with urllib.request.urlopen(url + "/api/stats", timeout=60) as r:
            before = json.loads(r.read())
        for k in kernels.values():
            k.reset()
        res = loadgen.run_trace(keep, make_request, loadgen.poisson_arrivals(1.0, 6, seed=seed),
                                drain_timeout_s=600)
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items()}
        with urllib.request.urlopen(url + "/api/stats", timeout=60) as r:
            stats = json.loads(r.read())
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
    finally:
        backend.shutdown()
    lens = {}
    for sd, data in sorted(replies.items()):
        with wave.open(io.BytesIO(data)) as w:
            lens[sd] = (w.getframerate(), w.getnchannels(), w.getsampwidth(), w.getnframes())
    want = {sd: (SR, 1, 2, max(ntok.get(sd, -1), 1) * HOP) for sd in range(900, 906)}
    out = {"checkpoints_s": ckpt_s, "build_s": build_s, "prewarm_s": prewarm_s,
           "load": res.row(), "latency_ms": res.lat_ms, "stats": stats,
           "tokens": ntok, "launches": launches}
    log(f"http {dtype} (bins/serve.py, continuous, {nvidia_smi()}): " + json.dumps(out))
    check(f"http {dtype}: six voice requests answered with well-formed wavs",
          res.n_ok == 6 and res.n_err == 0 and lens == want and len(ntok) == 6,
          f"{res.n_ok} ok, {res.n_err} failed; (rate, channels, width, samples) {lens}, want "
          f"120 samples per generated token {want}")
    check(f"http {dtype}: /api/stats is the continuous engine's",
          stats.get("batcher") == "continuous" and stats["chunks"] > before["chunks"]
          and stats["admitted"] == before["admitted"] + 6 and stats["solo_served"] == 0,
          f"batcher {stats.get('batcher')}, chunks {before['chunks']} -> {stats.get('chunks')}, "
          f"admitted {before['admitted']} -> {stats.get('admitted')}, mean slot occupancy "
          f"{stats.get('mean_slot_occupancy')}, solo {stats.get('solo_served')} (the engine "
          "replays graphs, so the solo path declines)")
    gemv = "int8_matmul" if dtype == "int8" else "int4_matmul"
    path = ("mel", gemv, "flash_attn_fwd", "rms_norm", "bf16_gemv")
    check(f"http {dtype}: the path's kernels launched",
          all(launches[k] > 0 for k in path) and launches["decode_attn_int8"] == 0,
          json.dumps(launches))
    return out


def engine_kernel_rows(v8: dict, http: dict) -> list:
    """The kernels this slice added, at the engine's step (4 rows) on the
    int8 pipeline's own weights: the RMSNorm (the decoder's first input
    norm's gain) and the lm_head GEMV, each against its plain version, by
    CUDA-graph replays beside its bound and one PyTorch call computing the
    same function (`F.rms_norm`, `F.linear`); launches from the HTTP run."""
    from amphion_tpu_torch.ops.kernels.bf16_gemv import bf16_linear, bf16_linear_ref
    from amphion_tpu_torch.ops.kernels.rms_norm import rms_norm, rms_norm_ref

    ar = v8["pipe"].ar
    g = torch.Generator(DEV).manual_seed(12)
    m = ENGINE_SLOTS
    x = (torch.randn((m, AR_HIDDEN), generator=g, device=DEV) * 2).bfloat16()
    gain = ar.decoder.layer_0.input_norm.scale.detach()
    w = ar.lm_head.weight.detach()
    rows = []
    for name, src, fn, ref, lib, ops, nbytes, jax_line in (
            ("rms_norm", "rms_norm.cu", lambda: rms_norm(x, gain, 1e-6),
             lambda: rms_norm_ref(x, gain, 1e-6),
             lambda: F.rms_norm(x, (AR_HIDDEN,), gain, 1e-6), 4.0 * m * AR_HIDDEN,
             2 * (2 * m * AR_HIDDEN + AR_HIDDEN), "amphion_tpu/modules/llama.py:131"),
            ("bf16_gemv", "bf16_gemv.cu", lambda: bf16_linear(x, w), lambda: bf16_linear_ref(x, w),
             lambda: F.linear(x, w), 2.0 * m * w.numel(),
             2 * (w.numel() + m * AR_HIDDEN + m * w.shape[0]),
             "amphion_tpu/models/vc/ar_transformer.py:331")):
        out, want = fn(), ref()
        err = (out.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        check(f"{name} at the engine's step ({m} rows) against its plain version",
              err <= 2e-2 * scale and torch.equal(fn(), out),
              f"max|err| {err:.3g} (tol 2e-2 of {scale:.3g}), relaunch bit-equal")
        bound, by = _bound(ops, nbytes)
        ms, plain, lib_ms = graph_ms(fn), graph_ms(ref), graph_ms(lib)
        log(f"timing {name} ({nvidia_smi()}): ({m}, {AR_HIDDEN}) bf16, kernel {ms} ms, plain "
            f"{plain} ms, library {lib_ms} ms, bound {bound} ms ({by})")
        row = _row(name, src, 0, http["launches"][name], err, ms, plain, bound, by, lib_ms,
                   ms_is=f"one call at the engine's {m}-row decode step, CUDA-graph replays",
                   launches_are="the HTTP voice run's (graph replays counted)")
        row["replaces"] = f"{jax_line} (computed by XLA there: no Pallas kernel)"
        rows.append(row)
    return rows


def _row(name, src, line, launches, err, ms, plain, bound, by, lib, **extra):
    return {"name": name, "route": "cuda",
            "source": f"amphion_tpu_torch/ops/kernels/csrc/{src}",
            "replaces": f"amphion_tpu/ops/pallas_kernels.py:{line}",
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib, **extra}


def _bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_BF16, nbytes / HBM
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def quant_timing_phase(v8: dict, v4: dict, fused: dict) -> list:
    """Kernels 4, 5 and 8 at the voice path's shapes against their bounds,
    their plain versions and, for kernel 4, ``torch._weight_int8pack_mm``.

    The matmul rows time one decode step's projections (24 layers x qkv, o,
    gateup, down at M = 4 rows, the pipelines' own weights, 534.7 MB in
    int8, more than the L2 holds), bound by their bytes, and each projection
    alone at M = 1, 4 and 8 beside its own bound (``per_projection_*``, 24
    calls a replay); kernel 5's row also times the step and its qkv and
    gateup with the RMSNorm prologue as AMPHION_FUSED_RMS=1 runs them
    (``prologue_*``); the ``gemm_*`` keys time the GEMM path (M > 8) at each
    projection of the flow matching (the batch's B * L rows) and of the AR
    prefill (its rows; kernel 5 also with the prologue on qkv and gateup),
    on the first layer's weights, by CUDA-graph replays, beside each one's
    bound (bf16 operations) and library call and, at the FM qkv, the plain
    version, and carry the voice batch's GEMM launches.
    Decode attention is timed on the fused single-utterance run's recorded
    calls at its first, middle and last recorded steps (each step's 24
    layers in one replay), and on one random cache at the middle length."""
    from amphion_tpu_torch.ops.kernels.decode_attention import (
        decode_attention_int8, decode_attention_int8_ref)
    from amphion_tpu_torch.ops.kernels.int4_matmul import (
        int4_matmul, int4_matmul_ref, unpack_int4)
    from amphion_tpu_torch.ops.kernels.int8_matmul import int8_matmul, int8_matmul_ref

    dev = torch.device(DEV)
    g = torch.Generator(dev).manual_seed(2)
    m = 4

    def projections(ar):
        for i in range(AR_LAYERS):
            layer = getattr(ar.decoder, f"layer_{i}")
            yield from (layer.attn.qkv_proj, layer.attn.o_proj, layer.mlp.gateup_proj,
                        layer.mlp.down_proj)

    xs = {k: torch.randn((m, k), generator=g, device=dev).bfloat16() for k in (AR_HIDDEN, AR_FFN)}

    def tinygemm(q):
        """A QDense4 in the layout of ``torch._weight_int4pack_mm`` (values
        offset by 8, the high nibble first, zero points 0)."""
        u = unpack_int4(q.kernel_q).to(torch.int32) + 8
        packed = torch._convert_weight_to_int4pack(((u[:, ::2] << 4) | u[:, 1::2])
                                                   .to(torch.uint8), 8)
        sz = torch.stack([q.scale, torch.zeros_like(q.scale)], dim=-1).bfloat16()
        return packed, q.group, sz

    def library(name, mods, x_of):
        """One PyTorch call per projection computing the same product, held
        to 2e-2 of max|ref| against the plain version on the first one (else
        reported as missing): ``torch._weight_int8pack_mm`` for kernel 4,
        ``torch._weight_int4pack_mm`` for kernel 5."""
        try:
            if name == "int8_matmul":
                args = [(q.kernel_q, q.scale.bfloat16()) for q in mods]
                fn = torch._weight_int8pack_mm
            else:
                args = [tinygemm(q) for q in mods]
                fn = torch._weight_int4pack_mm
            q0 = mods[0]
            ref0 = (int8_matmul_ref(x_of(q0), q0.kernel_q, q0.scale) if name == "int8_matmul"
                    else int4_matmul_ref(x_of(q0), q0.kernel_q, q0.scale, q0.group))
            err = (fn(x_of(q0), *args[0]).float() - ref0).abs().max().item()
            if err > 2e-2 * ref0.abs().max().item():
                log(f"timing {name}: the library call disagrees (max|err| {err:.3g}); not timed")
                return None
            return graph_ms(lambda: [fn(x_of(q), *a) for q, a in zip(mods, args)])
        except (RuntimeError, AttributeError, NotImplementedError) as e:
            log(f"timing {name}: no library call: {str(e)[:160]}")
            return None

    rows = []
    for name, v, mm, ref, line, src in (
            ("int8_matmul", v8, int8_matmul, int8_matmul_ref, 511, "int8_matmul.cu"),
            ("int4_matmul", v4, int4_matmul, int4_matmul_ref, 679, "int4_matmul.cu")):
        mods = list(projections(v["pipe"].ar))
        extra = (lambda q: (q.group,)) if name == "int4_matmul" else (lambda q: ())

        def call(fn, q, dt=torch.bfloat16):
            x = xs[q.kernel_q.shape[1] * (2 if name == "int4_matmul" else 1)]
            return fn(x, q.kernel_q, q.scale, *extra(q), out_dtype=dt)

        per_shape, per_bound, pro_shape = {}, {}, {}
        gg = torch.Generator(dev).manual_seed(3)
        gains = {k: 1 + 0.1 * torch.randn((k,), generator=gg, device=dev)
                 for k in (AR_HIDDEN, AR_FFN)}
        for rows_m in (1, m, 8):
            xm = {k: torch.randn((rows_m, k), generator=g, device=dev).bfloat16()
                  for k in (AR_HIDDEN, AR_FFN)}
            for i, label in enumerate(("qkv", "o", "gateup", "down")):
                sub = mods[i::4]
                k_in = sub[0].kernel_q.shape[1] * (2 if name == "int4_matmul" else 1)
                key = f"M={rows_m} {label}"
                per_shape[key] = graph_ms(lambda: [
                    mm(xm[k_in], q.kernel_q, q.scale, *extra(q), out_dtype=torch.bfloat16)
                    for q in sub]) / len(sub) * 1e3
                n_out = sub[0].kernel_q.shape[0]
                per_bound[key] = _bound(2.0 * rows_m * k_in * n_out, sum(
                    q.kernel_q.numel() + 4 * q.scale.numel() for q in sub) / len(sub)
                    + 2 * rows_m * (k_in + n_out))[0] * 1e3
                if name == "int4_matmul" and rows_m == m and label in PROLOGUE_PROJ:
                    pro_shape[key] = graph_ms(lambda: [
                        mm(xm[k_in], q.kernel_q, q.scale, q.group, gains[k_in], 1e-6,
                           out_dtype=torch.bfloat16) for q in sub]) / len(sub) * 1e3
        log(f"timing {name}: us per call by projection and rows (CUDA graph, "
            f"{len(mods) // 4} layers' weights each): " + json.dumps(per_shape)
            + "; bound us " + json.dumps(per_bound)
            + (f"; with the RMSNorm prologue {json.dumps(pro_shape)}" if pro_shape else ""))
        eager_ms = gpu_ms(lambda: [call(mm, q) for q in mods])
        k_ms = graph_ms(lambda: [call(mm, q) for q in mods])
        pro_ms = None
        if name == "int4_matmul":  # the step as AMPHION_FUSED_RMS=1 runs it
            pro_ms = graph_ms(lambda: [
                mm(xs[q.kernel_q.shape[1] * 2], q.kernel_q, q.scale, q.group,
                   gains[q.kernel_q.shape[1] * 2] if i % 4 in (0, 2) else None, 1e-6,
                   out_dtype=torch.bfloat16) for i, q in enumerate(mods)])
        p_ms = graph_ms(lambda: [call(ref, q) for q in mods], iters=5)
        nbytes = sum(q.kernel_q.numel() + 4 * q.scale.numel() for q in mods)
        nbytes += sum(2 * m * (q.kernel_q.shape[1] * (2 if name == "int4_matmul" else 1)
                               + q.kernel_q.shape[0]) for q in mods)
        ops = sum(2.0 * m * q.kernel_q.shape[0] * q.kernel_q.shape[1]
                  * (2 if name == "int4_matmul" else 1) for q in mods)
        bound, by = _bound(ops, nbytes)
        lib = library(name, mods, lambda q: xs[q.kernel_q.shape[1] * (2 if name == "int4_matmul" else 1)])
        log(f"timing {name}: one decode step ({len(mods)} projections, M={m}, "
            f"{nbytes / 1e6:.1f} MB, device time of a CUDA-graph replay) kernel {k_ms} ms "
            + (f"(with the RMSNorm prologue on qkv and gateup {pro_ms} ms) " if pro_ms else "")
            + f"({eager_ms} ms launched one by one from Python), plain {p_ms} ms, library "
            f"{lib} ms, bound {bound} ms ({by})")
        # the GEMM at each projection of the flow matching and the AR prefill
        gemm = {"gemm_ms": {}, "gemm_bound_ms": {}, "gemm_library_ms": {}, "gemm_plain_ms": {}}
        if name == "int4_matmul":
            gemm["gemm_prologue_ms"] = {}
        gemm_rows = {"FM": v["shapes"]["fm_rows"], "prefill": v["shapes"]["ar_prefill_rows"]}
        for tag, stack in (("FM", v["pipe"].fm.diff_estimator.encoder), ("prefill", v["pipe"].ar.decoder)):
            layer = stack.layer_0
            for label, q in zip(("qkv", "o", "gateup", "down"),
                                (layer.attn.qkv_proj, layer.attn.o_proj, layer.mlp.gateup_proj,
                                 layer.mlp.down_proj)):
                k_in = q.kernel_q.shape[1] * (2 if name == "int4_matmul" else 1)
                n_out, rows_g = q.kernel_q.shape[0], gemm_rows[tag]
                xg = torch.randn((rows_g, k_in), generator=g, device=dev).bfloat16()
                key = f"{tag} {label}"
                gemm["gemm_ms"][key] = graph_ms(
                    lambda: mm(xg, q.kernel_q, q.scale, *extra(q), out_dtype=torch.bfloat16))
                gemm["gemm_bound_ms"][key] = _bound(
                    2.0 * rows_g * k_in * n_out,
                    q.kernel_q.numel() + 4 * q.scale.numel() + 2 * rows_g * (k_in + n_out))[0]
                gemm["gemm_library_ms"][key] = library(name, [q], lambda _: xg)
                if key == "FM qkv":  # the plain version at one GEMM shape
                    gemm["gemm_plain_ms"][key] = graph_ms(
                        lambda: ref(xg, q.kernel_q, q.scale, *extra(q), out_dtype=torch.bfloat16),
                        iters=3)
                if name == "int4_matmul" and tag == "prefill" and label in PROLOGUE_PROJ:
                    gemm["gemm_prologue_ms"][key] = graph_ms(lambda: mm(
                        xg, q.kernel_q, q.scale, q.group, gains[k_in], 1e-6,
                        out_dtype=torch.bfloat16))
        log(f"timing {name}: the GEMM by projection (ms, CUDA graph, rows {json.dumps(gemm_rows)}): "
            + json.dumps(gemm))
        err = max(v["path_err"], fused["prologue_err"] if name == "int4_matmul" else 0.0)
        more = ({"prologue_ms": pro_ms, "prologue_per_projection_us": pro_shape}
                if pro_ms else {})
        more.update(gemm, gemm_rows=gemm_rows, gemm_launches=v["gemm_launches"])
        rows.append(_row(name, src, line, v["launches"][name], err, k_ms, p_ms, bound,
                         by, lib, per_projection_us=per_shape,
                         per_projection_bound_us=per_bound, **more))

    # decode attention: one decode step's 24 recorded calls (each layer's own
    # cache, so the step streams from device memory as the path does) at the
    # first, middle and last recorded steps; and, as in earlier runs, one
    # random cache at the middle step's length called 24 times (L2-resident)
    s_len, d = fused["cache_len"], AR_HIDDEN // AR_HEADS

    def attn_bound(valid):
        return _bound(4.0 * AR_HEADS * valid * d,
                      AR_HEADS * valid * (2 * d + 8) + 8 * AR_HEADS * d + 4)

    inputs = fused["attn_inputs"]
    steps = sorted(inputs)
    picked = [steps[0], min(steps, key=lambda st: abs(st - steps[-1] / 2)), steps[-1]]
    per_len = []
    for step in picked:
        calls = inputs[step]
        valid = int(calls[0][5][0])
        per_len.append({
            "step": step, "valid_len": valid,
            "ms": graph_ms(lambda: [decode_attention_int8(*c) for c in calls]) / len(calls),
            "plain_ms": graph_ms(lambda: [decode_attention_int8_ref(*c) for c in calls],
                                 iters=3) / len(calls),
            "bound_ms": attn_bound(valid)[0]})
    valid = per_len[1]["valid_len"]
    q = torch.randn((1, AR_HEADS, d), generator=g, device=dev)
    ck, cv = (torch.randint(-127, 128, (1, AR_HEADS, s_len, d), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((1, AR_HEADS, s_len), generator=g, device=dev) * 0.02 for _ in range(2))
    lens = torch.tensor([valid], device=dev, dtype=torch.int32)
    synthetic = {"valid_len": valid, "ms": graph_ms(
        lambda: [decode_attention_int8(q, ck, cv, ks, vs, lens)
                 for _ in range(AR_LAYERS)]) / AR_LAYERS,
        "plain_ms": graph_ms(lambda: decode_attention_int8_ref(q, ck, cv, ks, vs, lens)),
        "bound_ms": attn_bound(valid)[0]}
    a_ms, a_plain, a_bound = (sum(r[k] for r in per_len) / len(per_len)
                              for k in ("ms", "plain_ms", "bound_ms"))
    log(f"timing decode_attn_int8 ({nvidia_smi()}): (1, {AR_HEADS}, S={s_len}, {d}), device "
        f"time of a CUDA-graph replay of one decode step's {AR_LAYERS} recorded calls, per "
        f"call, by step: {json.dumps(per_len)}; mean kernel {a_ms} ms, plain {a_plain} ms, "
        f"bound {a_bound} ms (bytes); one random cache called {AR_LAYERS} times: "
        f"{json.dumps(synthetic)}; library none (no single PyTorch call attends over an "
        "int8 cache)")
    rows.append(_row("decode_attn_int8", "decode_attn_int8.cu", 1202, fused["attn_launches"],
                     fused["attn_path"]["max_abs_err"], a_ms, a_plain, a_bound,
                     attn_bound(valid)[1], None,
                     ms_is="mean over the first, middle and last recorded decode steps of "
                           "the fused single-utterance run, per call, each step's 24 "
                           "recorded calls in one CUDA-graph replay",
                     per_valid_len=per_len, random_cache=synthetic,
                     max_rel_err=fused["attn_path"]["max_rel_err"],
                     max_abs_err_random_inputs=fused["attn_err"]))
    return rows


# -- Vevo training: kernel 7 and the FM and AR trainers ---------------------------

TRAIN_STEPS, TRAIN_SAVE = 8, 4
TRAIN = {  # stage → (model_type, layers, (B, L, H, D) of attention, causal, loss key)
    "fm": ("FlowMatchingTransformer", FM_LAYERS, (8, 256, 16, 64), False, "fm_loss"),
    "ar": ("AutoregressiveTransformer", AR_LAYERS, (8, 516, AR_HEADS, 64), True, "ar_loss"),
}
BWD_CASES = {  # name → b, lq, lk, h, kvh, d, causal, mask ("ones" or "ragged")
    "fm_train": (8, 256, 256, 16, 16, 64, False, "ones"),
    "ar_train": (8, 516, 516, AR_HEADS, AR_HEADS, 64, True, "ragged"),
    "gqa_uneven": (2, 200, 333, 8, 2, 64, False, "ragged"),
}


def bwd_inputs(case, dtype, g):
    b, lq, lk, h, kvh, d, causal, kind = BWD_CASES[case]
    dev = torch.device(DEV)
    q, do = (torch.randn((b, lq, h, d), generator=g, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, lk, kvh, d), generator=g, device=dev).to(dtype) for _ in range(2))
    if kind == "ones":
        mask = torch.ones((b, lk), device=dev)
    else:  # ragged: row i keeps its first lk - 37 i keys
        valid = torch.tensor([lk - 37 * i for i in range(b)], device=dev)
        mask = (torch.arange(lk, device=dev)[None] < valid[:, None]).float()
    return q, k, v, mask, do, causal


def dense_attention64(q, k, v, mask, causal):
    """float64 attention with the kernels' masking (-1e30), for autograd."""
    rep = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(rep, 2)) / math.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device).tril(),
                          -1e30)
    s = s.masked_fill(~(mask > 0)[:, None, None, :], -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.repeat_interleave(rep, 2))


def bwd_kernel_phase(flash_mod, seed: int) -> dict:
    """Kernel 7 against its plain version at the trainers' shapes and a GQA
    case with uneven unequal lengths, in float32 (dq, dk, dv within 1e-4 of
    max|ref|: float32 sums in another order) and bf16 (2e-2 of max|ref| and
    1e-2 relative Frobenius, the forward's gate); two launches on the same
    inputs give the same bits (no atomics); and the autograd Function
    (kernel 6 then 7) in float32 against float64 autograd, within 1e-4 of
    max|ref|. Returns the largest float32 error at the FM shape."""
    g = torch.Generator(DEV).manual_seed(seed + 17)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        log(f"kernel flash_attn_bwd ({dtype}):")
        for case in BWD_CASES:
            q, k, v, mask, do, causal = bwd_inputs(case, dtype, g)
            out, lse = flash_mod.flash_attention(q, k, v, mask, causal, return_lse=True)
            grads = flash_mod.flash_attention_bwd(q, k, v, mask, out, lse, do, causal)
            again = flash_mod.flash_attention_bwd(q, k, v, mask, out, lse, do, causal)
            torch.cuda.synchronize()
            refs = flash_mod.flash_attention_bwd_ref(q, k, v, mask, out, lse, do, causal)
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
                if dtype == torch.float32:
                    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
                    ok, detail = err <= 1e-4 * scale, f"max|err| {err:.3g} (tol 1e-4 of {scale:.3g})"
                    if case == "fm_train":
                        worst = max(worst, err)
                else:
                    ok, detail = close_bf16(got, ref)
                check(f"{case} {tuple(q.shape)} k {tuple(k.shape)} causal={causal} {name}",
                      ok and same, f"{detail}; bit-equal on relaunch: {same}")
    log("autograd Function (kernel 6 + 7, float32) against float64 autograd:")
    for case in BWD_CASES:
        q, k, v, mask, do, causal = bwd_inputs(case, torch.float32, g)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(flash_mod.flash_attention(*leaves, mask, causal), leaves, do)
        leaves64 = [x.double().requires_grad_() for x in (q, k, v)]
        refs = torch.autograd.grad(dense_attention64(*leaves64, mask, causal), leaves64,
                                   do.double())
        for name, a, b in zip(("dq", "dk", "dv"), got, refs):
            err, scale = (a.double() - b).abs().max().item(), b.abs().max().item()
            check(f"Function {case} {name}", err <= 1e-4 * scale,
                  f"max|err| {err:.3g} (tol 1e-4 of {scale:.3g})")
    return {"flash_bwd": worst}


def synth_corpus(root, seed: int, n: int = 16):
    """``n`` 24 kHz clips of at most one 1.28 s training segment (so the
    dataset draws no random offsets) and their train.json."""
    from amphion_tpu_torch.data.audio_io import save_wav
    from amphion_tpu_torch.data.metadata import Utterance, save_metadata

    rng = np.random.default_rng(seed + 23)
    utts = []
    for i in range(n):
        sec = float(rng.uniform(0.9, 1.28))
        path = root / "wav" / f"{i:02d}.wav"
        save_wav(path, synth_audio(rng, sec), SR)
        utts.append(Utterance("smoke", f"clip{i:02d}", str(path), sec))
    save_metadata(root / "data" / "smoke" / "train.json", utts)


def train_config(root, name: str, **train) -> str:
    """config/vevo.json at full width, with the smoke corpus, a log dir and a
    metrics file under ``root`` and the ``train`` overrides."""
    cfg = {"base_config": os.path.abspath("config/vevo.json"), "dataset": ["smoke"],
           "log_dir": str(root / "ckpts"), "preprocess": {"processed_dir": str(root / "data")},
           "train": {"log_interval": 1, "metrics_path": str(root / f"{name}.jsonl"), **train}}
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def metrics(root, name: str) -> list[dict]:
    return [json.loads(x) for x in (root / f"{name}.jsonl").read_text().splitlines()]


TRAIN_GROUPS = [("flash_attn_fwd", "flash_fwd"), ("flash_attn_bwd", "bwd_d"),
                ("mel", "mel_kernel"), ("optimizer", "multi_tensor_apply")]


def profile_steps(trainer, n: int = 2) -> dict:
    """``n`` more training steps of ``trainer`` under torch.profiler (device
    activity only), on batches made beforehand: wall, device-busy share and
    device time by group (kernels 6 and 7, cuBLAS GEMMs, the AdamW update,
    the other elementwise and reduction work)."""
    from torch.profiler import ProfilerActivity, profile

    bs = trainer.batch_size
    batches = [trainer._make_batch(list(range(i * bs, (i + 1) * bs))) for i in range(n)]
    state = trainer.loop.states
    # the operations of the step's matrix products: 2·rows·in·out per Linear
    # call in the forward, twice that again in the backward
    fwd = [0.0]

    def count(mod, args, out):
        fwd[0] += 2.0 * args[0].numel() / args[0].shape[-1] * mod.in_features * mod.out_features

    hooks = [m.register_forward_hook(count) for m in state.model.modules()
             if isinstance(m, torch.nn.Linear)]
    with torch.no_grad():
        trainer._loss(state, batches[0])
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            state, aux = trainer._step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = {name: 0.0 for name, _ in TRAIN_GROUPS}
    groups.update(gemm=0.0, other=0.0)
    by_name, n_records = device_us_by_name(prof)
    for name, us in by_name.items():
        group = next((g for g, pat in TRAIN_GROUPS if pat in name), None)
        if group is None:
            group = "gemm" if any(t in name for t in LIBRARY_GEMM) else "other"
        groups[group] += us
    busy = sum(groups.values()) / 1e6
    top = sorted(((us, nm[:80]) for nm, us in by_name.items()), reverse=True)
    return {"steps": n, "wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_records": n_records, "by_group_s": {k: v / 1e6 for k, v in groups.items()},
            "per_step_ms": {k: v / 1e3 / n for k, v in groups.items()},
            "share_of_device_time": {k: v / 1e6 / busy for k, v in groups.items()},
            "gemm_tflop_per_step": 3 * fwd[0] / 1e12,
            "gemm_tflop_per_s": 3 * fwd[0] * n / (groups["gemm"] / 1e6) / 1e12,
            "top_kernels_ms": [[nm, us / 1e3] for us, nm in top[:6]]}


def train_launches(kernels: dict, layers: int, steps: int) -> tuple[bool, str]:
    """The path's launch counts against those worked out beforehand: one mel
    per batch (each epoch's batches are all consumed, none made ahead past
    the last step), kernels 6 and 7 once per layer and step, no other."""
    got = {name: k.launches for name, k in kernels.items()}
    want = {name: 0 for name in kernels}
    want.update(mel=steps, flash_attn_fwd=layers * steps, flash_attn_bwd=layers * steps)
    return got == want, f"{got} (predicted {want}: {layers} layers x {steps} steps)"


def train_phase(stage: str, seed: int, kernels: dict) -> dict:
    """One trainer at the full width of config/vevo.json through the normal
    entry point, `amphion_tpu_torch.bins.vc.train.main`: 8 steps with a
    checkpoint at step 4, then a resume from that checkpoint that must
    repeat steps 5-8's losses within 1e-5 relative, then a profiled rerun
    of two steps. Every launch count is set to 0 just before each run and
    read just after."""
    import shutil
    import tempfile
    from pathlib import Path

    from amphion_tpu_torch.bins.vc.train import main as train_main

    model_type, layers, shape, causal, key = TRAIN[stage]
    root = Path(tempfile.mkdtemp(prefix=f"vevo_{stage}_"))
    try:
        synth_corpus(root, seed)
        cfg = train_config(root, "run", max_steps=TRAIN_STEPS,
                           save_checkpoints_steps=TRAIN_SAVE)
        for k in kernels.values():
            k.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = train_main(["--config", cfg, "--model_type", model_type, "--exp_name", "run"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches_ok, launches_detail = train_launches(kernels, layers, TRAIN_STEPS)
        launches = {name: k.launches for name, k in kernels.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        model = trainer.loop.states.model
        n_params = sum(p.numel() for p in model.parameters())
        rows = metrics(root, "run")
        losses = [r[key] for r in rows]
        log(f"train {stage}: {model_type} {n_params / 1e6:.1f} M params, float32, batch "
            f"{trainer.batch_size}, attention {shape} causal={causal}; {TRAIN_STEPS} steps in "
            f"{wall:.1f} s (build and checkpoints included); losses {losses}")
        check(f"train {stage} losses", len(losses) == TRAIN_STEPS
              and all(math.isfinite(x) for x in losses), f"{len(losses)} finite")
        fg = trainer.first_grads
        # FM: the flow-time MLP reaches the loss only through the adaptive
        # norms' projections, whose kernels start at 0 (as in JAX), so its
        # first gradient is exactly 0; every other tensor must get one
        expect_zero = "diff_estimator.diff_step_mlp." if stage == "fm" else None
        bad_zero = [n for n in fg["all_zero"]
                    if expect_zero is None or not n.startswith(expect_zero)]
        check(f"train {stage} step-1 gradients", not fg["missing"] and not bad_zero,
              f"{fg['tensors']} tensors; without a gradient {fg['missing']}; all zero "
              f"{fg['all_zero']} (allowed: the flow-time MLP's, FM only)")
        check(f"train {stage} launches", launches_ok, launches_detail)
        med = statistics.median(r["step_s"] for r in rows[2:])
        b, length = trainer.batch_size, shape[1]
        unit = "frames" if stage == "fm" else "packed tokens"
        perf = {"median_step_s": med, "step_s": [r["step_s"] for r in rows],
                f"{unit.replace(' ', '_')}_per_s": b * length / med,
                "max_memory_allocated_gib": peak}
        log(f"train {stage} perf ({nvidia_smi()}): median step {med:.4f} s over steps 3-"
            f"{TRAIN_STEPS}, {b * length / med:.0f} {unit}/s ({b} x {length} per step), "
            f"peak {peak:.2f} GiB; " + json.dumps(perf))

        # resume from the step-4 checkpoint, in a run directory of its own
        ckdir = root / "ckpts" / "run" / "checkpoint"
        step4 = next(p for p in ckdir.glob("epoch-*") if f"_step-{TRAIN_SAVE:07d}_" in p.name)
        (root / "ckpts" / "resume" / "checkpoint").mkdir(parents=True)
        (root / "ckpts" / "resume" / "checkpoint" / step4.name).symlink_to(step4)
        prof = profile_steps(trainer)
        log(f"train {stage} trace ({nvidia_smi()}): " + json.dumps(prof))
        del trainer, model
        gc.collect()
        torch.cuda.empty_cache()
        for k in kernels.values():
            k.reset()
        cfg2 = train_config(root, "resume", max_steps=TRAIN_STEPS, save_checkpoints_steps=0)
        again = train_main(["--config", cfg2, "--model_type", model_type, "--exp_name", "resume",
                            "--resume"])
        resume_ok, resume_detail = train_launches(kernels, layers, TRAIN_STEPS - TRAIN_SAVE)
        rerun = [r[key] for r in metrics(root, "resume")]
        first = losses[TRAIN_SAVE:]
        rel = max(abs(a - b) / abs(b) for a, b in zip(rerun, first)) if rerun else math.inf
        check(f"train {stage} resume", len(rerun) == len(first) and rel <= 1e-5 and resume_ok,
              f"steps {TRAIN_SAVE + 1}-{TRAIN_STEPS} from the step-{TRAIN_SAVE} checkpoint: "
              f"max relative difference {rel:.3g} (tol 1e-5), bit-equal {rerun == first}; "
              f"launches {resume_detail}")
        del again
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "perf": perf, "trace": prof, "resume_bit_equal": rerun == first}


def train_reference_phase(seed: int) -> None:
    """One step of a small float32 FM and AR (2 layers, hidden 256, 4 heads,
    D = 64) on the card and on the CPU with the same weights, the same
    batch (made once on the CPU: mel, tokens, masks) and the same injected
    flow time and noise: the loss within 1e-4 relative, every gradient
    within 1e-3 of its tensor's max|ref|."""
    import copy

    from amphion_tpu_torch.models.codec.repcodec import RepCodec, RepCodecConfig
    from amphion_tpu_torch.models.vc.ar_transformer import ARTransformer, ARTransformerConfig
    from amphion_tpu_torch.models.vc.flow_matching_transformer import (
        FlowMatchingTransformer, FMTConfig)
    from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram_ref
    from amphion_tpu_torch.utils.convert import init_like_flax

    gen = torch.Generator().manual_seed(seed + 29)
    rng = np.random.default_rng(seed + 29)
    b, n = 4, 128
    audio = torch.from_numpy(np.stack([synth_audio(rng, n * HOP / SR) for _ in range(b)]))
    mel = mel_spectrogram_ref(audio, MelConfig()).transpose(1, 2).contiguous()
    tok = init_like_flax(RepCodec(RepCodecConfig(feature_dim=80, hidden=128, codebook_size=512,
                                                 codebook_dim=8, num_blocks=2)), gen)
    tokens = tok.encode(mel).clone()
    pmask = (torch.arange(n)[None] < torch.tensor([20, 0, 40, 13])[:, None]).float()
    xmask = torch.ones((b, n))
    content = torch.from_numpy(rng.integers(0, 32, (b, 40)))
    cmask = (torch.arange(40)[None] < torch.tensor([40, 33, 17, 25])[:, None]).float()
    small = dict(hidden=256, num_layers=2, num_heads=4)
    models = {
        "fm": FlowMatchingTransformer(FMTConfig(token_vocab=512, **small)),
        "ar": ARTransformer(ARTransformerConfig(input_vocab=32, output_vocab=512,
                                                intermediate=512, **small)),
    }
    t = torch.rand((b,), generator=gen)
    noise = torch.randn(mel.shape, generator=gen)
    for stage, cpu in models.items():
        init_like_flax(cpu, gen)
        with torch.no_grad():  # move off the zero/one initialisers
            for p in cpu.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=gen))
        gpu = copy.deepcopy(cpu).to(DEV)
        res = {}
        for name, m in (("cuda", gpu), ("cpu", cpu)):
            dev = next(m.parameters()).device
            if stage == "fm":
                loss, _ = m.loss(mel.to(dev), tokens.to(dev), pmask.to(dev), xmask.to(dev),
                                 t=t.to(dev), noise=noise.to(dev))
            else:
                loss, _ = m.loss(content.to(dev), cmask.to(dev), tokens.to(dev),
                                 torch.ones((b, n), device=dev))
            loss.backward()
            res[name] = (loss.item(), {k: p.grad.cpu() for k, p in m.named_parameters()})
        rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        worst, worst_name = 0.0, ""
        for k, ref in res["cpu"][1].items():
            err = (res["cuda"][1][k] - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
            if err > worst:
                worst, worst_name = err, k
        check(f"reference: small f32 {stage} step, card vs CPU", rel <= 1e-4 and worst <= 1e-3,
              f"loss {res['cuda'][0]:.6f} vs {res['cpu'][0]:.6f} (rel {rel:.2g}, tol 1e-4); "
              f"worst gradient {worst_name} max|err|/max|ref| {worst:.2g} (tol 1e-3) over "
              f"{len(res['cpu'][1])} tensors")


def profiled_ms(fn, iters: int = 10) -> float:
    """Device time of one ``fn()`` from torch.profiler: the durations of
    every kernel it launched, summed over ``iters`` calls after warm-up,
    over ``iters`` (host gaps left out, as in a graph replay)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name, _ = device_us_by_name(prof)
    return sum(by_name.values()) / iters / 1e3


def sdpa_bwd_ms(qt, kt, vt, allowed, dot) -> tuple[float, str, str]:
    """The backward of ``F.scaled_dot_product_attention`` with the same
    mask, by ``torch.autograd.grad`` on a retained graph: timed by graph
    replays (its forward runs on the capture stream, so autograd launches
    the backward there), or by the profiler's device time where the capture
    fails. Returns (ms, method, backend)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed[:, None])
    torch.cuda.current_stream().wait_stream(side)
    grad = lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)  # noqa: E731
    try:
        return graph_ms(grad, stream=side), "graph replays", out.grad_fn.name()
    except Exception as exc:  # noqa: BLE001 - the profiler measures it instead
        log(f"  SDPA backward capture failed ({type(exc).__name__}: {exc}); profiler time")
        torch.cuda.synchronize()
        return profiled_ms(grad), "profiler", out.grad_fn.name()


def bwd_timing_phase(flash_mod, train: dict, errs: dict) -> tuple[dict, dict]:
    """Kernel 7 (and kernel 6's training forward) in float32 at the FM and
    AR training shapes, each by graph replays: the wrapper's time per call
    (Δ reduction included), the plain version's, SDPA's forward and
    backward with the same mask (`sdpa_bwd_ms`), and two bounds: 10 D
    operations per attended (query, key) pair at the 67 TFLOP/s float32
    FMA rate, or q, k, v, o, dO, dq, dk, dv and the LSE once over 3.35
    TB/s, the larger (``bound_ms``); and the same operations done as three
    TF32 products at the 495 TFLOP/s TF32 rate, as the kernels do them
    (``bound_3xtf32_ms``, the bound rule 2 holds a kernel to)."""
    g = torch.Generator(DEV).manual_seed(31)
    out = {}
    for stage, (_, _, (b, L, h, d), causal, _) in TRAIN.items():
        case = "fm_train" if stage == "fm" else "ar_train"
        q, k, v, mask, do, causal = bwd_inputs(case, torch.float32, g)
        o, lse = flash_mod.flash_attention(q, k, v, mask, causal, return_lse=True)
        bwd = lambda: flash_mod.flash_attention_bwd(q, k, v, mask, o, lse, do, causal)  # noqa: E731
        fwd = lambda: flash_mod.flash_attention(q, k, v, mask, causal, return_lse=True)  # noqa: E731
        allowed = (mask > 0)[:, None, :].expand(b, L, L)
        if causal:
            allowed = allowed & torch.ones((L, L), dtype=torch.bool, device=DEV).tril()
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt.detach(), kt.detach(), vt.detach(), attn_mask=allowed[:, None])
        log(f"timing flash {stage}, launched from Python (gpu_ms): backward {gpu_ms(bwd):.5f} ms, "
            f"forward with LSE {gpu_ms(fwd):.5f} ms, SDPA forward {gpu_ms(sdpa_fwd):.5f} ms")
        k_ms, f_ms, lib_fwd = graph_ms(bwd), graph_ms(fwd), graph_ms(sdpa_fwd)
        p_ms = graph_ms(lambda: flash_mod.flash_attention_bwd_ref(q, k, v, mask, o, lse, do,
                                                                  causal), iters=3)
        lib_ms, method, backend = sdpa_bwd_ms(qt, kt, vt, allowed, do.transpose(1, 2))
        pairs = float(allowed.sum()) * h
        ops, nbytes = 10.0 * d * pairs, 4.0 * (8 * b * L * h * d + b * h * L)
        t_ops, t_bytes = ops / PEAK_F32, nbytes / HBM
        bound, by = max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
        bound_tc = max(3 * ops / PEAK_TF32, t_bytes) * 1e3
        # the forward with the LSE: QK^T and PV, 4 D per pair; q, k, v, o and the LSE
        f_bytes = 4.0 * (4 * b * L * h * d + b * h * L) / HBM
        f_bound = max(4.0 * d * pairs / PEAK_F32, f_bytes) * 1e3
        f_bound_tc = max(3 * 4.0 * d * pairs / PEAK_TF32, f_bytes) * 1e3
        out[stage] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                      "bound_3xtf32_ms": bound_tc, "library_ms": lib_ms,
                      "library_backend": backend, "library_timing": method, "fwd_ms": f_ms,
                      "fwd_library_ms": lib_fwd, "fwd_bound_ms": f_bound,
                      "fwd_bound_3xtf32_ms": f_bound_tc, "pairs": pairs}
        log(f"timing flash_attn_bwd {stage} ({b}, {L}, {h}, {d}) f32 causal={causal} "
            f"(graph replays, {nvidia_smi()}): kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, "
            f"library (SDPA backward, {backend}, {method}) {lib_ms:.5f} ms, bound {bound:.5f} ms "
            f"({by}: {ops / 1e9:.2f} GFLOP at 67 TFLOP/s, {nbytes / 1e6:.1f} MB), 3xTF32 bound "
            f"{bound_tc:.5f} ms; forward with LSE {f_ms:.5f} ms (SDPA {lib_fwd:.5f} ms, bound "
            f"{f_bound:.5f} ms, 3xTF32 bound {f_bound_tc:.5f} ms)")
    fm, ar = out["fm"], out["ar"]
    launches = train["fm"]["launches"]["flash_attn_bwd"] + train["ar"]["launches"]["flash_attn_bwd"]
    row = _row("flash_attn_bwd", "flash_attn_bwd.cu", 1044, launches, errs["flash_bwd"],
               fm["ms"], fm["plain_ms"], fm["bound_ms"], fm["bound_by"], fm["library_ms"],
               shape="fm (8, 256, 16, 64) f32; ar_* (8, 516, 20, 64) f32 causal",
               launches_per_step={s: train[s]["launches"]["flash_attn_bwd"] / TRAIN_STEPS
                                  for s in ("fm", "ar")},
               bound_3xtf32_ms=fm["bound_3xtf32_ms"], library_backend=fm["library_backend"],
               timing=f"graph replays; SDPA backward: {fm['library_timing']}",
               ar_ms=ar["ms"], ar_plain_ms=ar["plain_ms"], ar_bound_ms=ar["bound_ms"],
               ar_bound_3xtf32_ms=ar["bound_3xtf32_ms"], ar_library_ms=ar["library_ms"],
               ar_library_backend=ar["library_backend"],
               ar_library_timing=ar["library_timing"],
               also_replaces="amphion_tpu/ops/pallas_kernels.py:1073")
    fwd_extra = {"train_f32_ms": {"fm": fm["fwd_ms"], "ar": ar["fwd_ms"]},
                 "train_f32_bound_ms": {"fm": fm["fwd_bound_ms"], "ar": ar["fwd_bound_ms"]},
                 "train_f32_bound_3xtf32_ms": {"fm": fm["fwd_bound_3xtf32_ms"],
                                               "ar": ar["fwd_bound_3xtf32_ms"]},
                 "train_f32_library_ms": {"fm": fm["fwd_library_ms"], "ar": ar["fwd_library_ms"]},
                 "train_launches": {s: train[s]["launches"]["flash_attn_fwd"] for s in TRAIN}}
    return row, fwd_extra


# -- BigVGAN copy synthesis: kernels 1 and 2 --------------------------------------

VOC_CONFIG = "egs/vocoder/gan/bigvgan/exp_config.json"
# (B, T, C) of the generator's activations at the egs training batch (16 x 64
# frames), and kernel 2's launches at each per forward: 3 AMP blocks x 3
# dilations x 2 per stage, plus the final activation at the last stage's shape
AMP_SHAPES = [(16, 320, 256), (16, 1280, 128), (16, 3840, 64), (16, 7680, 32)]
AMP_LAUNCHES = (18, 18, 18, 19)
AA_PER_FORWARD = sum(AMP_LAUNCHES)  # 73
VOC_SECONDS = (2.0, 3.5, 5.0, 6.5, 8.0, 10.0)  # the six copy-synthesis files
# operations per output element, a sine counted as one operation (the least
# it could cost; sinf takes tens of instructions): kernel 2's two 6-tap up
# FIRs (24), SnakeBeta on both phases (2 x 5) and the 12-tap down FIR (24);
# kernel 1's forward (5) and backward (dx 4, dalpha 9)
AA_OPS, SNAKE_OPS, SNAKE_BWD_OPS = 58, 5, 13
VOC_GROUPS = [("aa_snake", "aa_snake_kernel"), ("mel", "mel_kernel"),
              ("snake", "snake_")]
CONV_NAMES = ("conv", "xmma", "implicit", "cudnn", "winograd", "fft", "gemm", "cutlass",
              "sm90_", "nvjet")


def within_bf16_step(out, ref) -> tuple[bool, str]:
    """``out`` (bf16) equals ``ref`` (bf16, the float32 result rounded) or
    is one bf16 step (8 significant bits) away from it."""
    o, r = out.detach().float(), ref.detach().float()
    big = torch.maximum(o.abs(), r.abs()).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(big)) - 7)
    diff = (o - r).abs()
    return (bool((diff <= step).all()),
            f"{int((diff > 0).sum())} of {diff.numel()} differ, worst {float((diff / step).max()):.2f} "
            "bf16 steps (tol 1)")


def snake_kernel_phase(seed: int) -> dict:
    """Kernels 1 and 2 against their plain versions on the card.

    Kernel 2 at the egs training shapes, a ragged T and T < 13, float32
    bit-equal over the whole signal (the same arithmetic, each product and
    sum rounded on its own, with the same edge pad) and bf16 within one bf16
    step of the float32 result rounded; `AASnakeBetaFn`'s
    output and gradients (autograd of the unfused chain through cuDNN)
    against the CPU, within 1e-5 / 1e-4 of max|ref| (sums over time in
    another order). Kernel 1 through ``Snake(use_pallas=True)`` at the AMP
    shapes, a ragged T and a C that is not a multiple of 4: y and dx equal
    to the plain versions' float32 results to the bit, dalpha within 1e-5
    of max|ref| (bf16: y and dx within one step), dalpha bit-equal on
    relaunch. Returns the largest float32 errors."""
    from amphion_tpu_torch.modules.activations import Snake
    from amphion_tpu_torch.ops.kernels import aa_snake as aa_mod
    from amphion_tpu_torch.ops.kernels import snake as snake_mod

    g = torch.Generator(DEV).manual_seed(seed + 41)
    errs = {"aa_snake": 0.0, "snake": 0.0, "snake_bwd": 0.0}

    def params(c):
        return (torch.rand((c,), generator=g, device=DEV) * 1.5 + 0.5 for _ in range(2))

    def rel(out, ref):
        err = (out.float() - ref.float()).abs().max().item()
        return err, ref.float().abs().max().item()

    for dtype in (torch.float32, torch.bfloat16):
        log(f"kernel aa_snake ({dtype}):")
        for b, t, c in AMP_SHAPES + [(3, 1000, 96), (2, 12, 40), (1, 1, 8)]:
            x = (torch.randn((b, t, c), generator=g, device=DEV) * 3).to(dtype)
            alpha, beta = params(c)
            out = aa_mod.aa_snakebeta(x, alpha, beta)
            torch.cuda.synchronize()
            ref = aa_mod.aa_snakebeta_ref(x, alpha, beta)
            if dtype == torch.float32:
                err, scale = rel(out, ref)
                ok = torch.equal(out, ref)
                detail = f"bit-equal {ok} (max|err| {err:.3g} of {scale:.3g})"
                errs["aa_snake"] = max(errs["aa_snake"], err)
            else:
                ok, detail = within_bf16_step(out, ref)
            check(f"aa_snake {(b, t, c)}", ok and out.shape == x.shape and out.dtype == dtype,
                  detail)
    x = torch.randn((2, 1000, 64), generator=g, device=DEV) * 3
    alpha, beta = params(64)
    gout = torch.randn(x.shape, generator=g, device=DEV)
    leaves = [t.clone().requires_grad_() for t in (x, alpha, beta)]
    y = aa_mod.AASnakeBetaFn.apply(*leaves)
    grads = torch.autograd.grad(y, leaves, gout)
    cpu = [t.cpu().requires_grad_() for t in (x, alpha, beta)]
    y_cpu = aa_mod.AASnakeBetaFn.apply(*cpu)
    refs = torch.autograd.grad(y_cpu, cpu, gout.cpu())
    err, scale = rel(y.cpu(), y_cpu)
    check("AASnakeBetaFn (2, 1000, 64) output, card vs CPU", err <= 1e-5 * scale,
          f"max|err| {err:.3g} (tol 1e-5 of {scale:.3g})")
    for name, got, ref in zip(("dx", "dalpha", "dbeta"), grads, refs):
        err, scale = rel(got.cpu(), ref)
        check(f"AASnakeBetaFn {name}, card vs CPU autograd of the chain", err <= 1e-4 * scale,
              f"max|err| {err:.3g} (tol 1e-4 of {scale:.3g})")

    for dtype in (torch.float32, torch.bfloat16):
        log(f"kernel snake forward and backward through Snake(use_pallas=True) ({dtype}):")
        for b, t, c in AMP_SHAPES + [(2, 300, 8), (2, 300, 37)]:
            m = Snake(c, use_pallas=True).to(DEV)
            with torch.no_grad():
                m.alpha.copy_(next(params(c)))
            x = (torch.randn((b, t, c), generator=g, device=DEV) * 3).to(dtype).requires_grad_()
            gout = torch.randn((b, t, c), generator=g, device=DEV).to(dtype)
            y = m(x)
            y.backward(gout)
            torch.cuda.synchronize()
            a = m.alpha.detach()
            ref_y = snake_mod.snake_ref(x.detach(), a)
            ref_dx, ref_da = snake_mod.snake_bwd_ref(x.detach(), a, gout)
            dx2, da2 = snake_mod.snake_bwd(x.detach(), a, gout)
            same = torch.equal(da2, m.alpha.grad)
            err_a, scale_a = rel(m.alpha.grad, ref_da)
            ok_a = err_a <= 1e-5 * scale_a
            if dtype == torch.float32:
                (err_y, scale_y), (err_x, scale_x) = rel(y, ref_y), rel(x.grad, ref_dx)
                ok = torch.equal(y, ref_y) and torch.equal(x.grad, ref_dx)
                detail = (f"y {err_y:.3g} of {scale_y:.3g}, dx {err_x:.3g} of {scale_x:.3g} "
                          f"(want bit-equal: {ok}), dalpha {err_a:.3g} of {scale_a:.3g} (tol "
                          "1e-5 of max|ref|)")
                errs["snake"] = max(errs["snake"], err_y)
                errs["snake_bwd"] = max(errs["snake_bwd"], err_x, err_a)
            else:
                (ok_y, d_y), (ok_x, d_x) = within_bf16_step(y, ref_y), within_bf16_step(x.grad, ref_dx)
                ok = ok_y and ok_x
                detail = f"y: {d_y}; dx: {d_x}; dalpha {err_a:.3g} of {scale_a:.3g} (tol 1e-5)"
            check(f"snake {(b, t, c)}", ok and ok_a and same,
                  f"{detail}; dalpha bit-equal on relaunch: {same}")
    return errs


class AARecorder:
    """While installed, records every call of kernel 2's wrapper
    (`aa_snakebeta`, which `AASnakeBetaFn` looks up by its module-level
    name at each call): the inputs the path gave it and the output it got."""

    def __init__(self):
        from amphion_tpu_torch.ops.kernels import aa_snake as aa_mod

        self.mod, self.wrapped, self.calls = aa_mod, aa_mod.aa_snakebeta, []
        aa_mod.aa_snakebeta = self

    def __call__(self, x, alpha, beta):
        out = self.wrapped(x, alpha, beta)
        self.calls.append((x.clone(), alpha.clone(), beta.clone(), out.clone()))
        return out

    def remove(self) -> None:
        self.mod.aa_snakebeta = self.wrapped


def aa_file_shapes(gcfg, frames: int) -> list:
    """(B, T, C) of kernel 2's launches, in order, for one file of
    ``frames`` mel frames at batch 1: each stage's AMP blocks (2 per
    dilation), then the final activation at the last stage's shape."""
    shapes, t = [], frames
    per_stage = 2 * sum(len(d) for d in gcfg.resblock_dilation_sizes)
    for i, r in enumerate(gcfg.upsample_rates):
        t *= r
        shapes += [(1, t, gcfg.upsample_initial_channel // 2 ** (i + 1))] * per_stage
    return shapes + shapes[-1:]


def aa_path_check(calls: list, want_shapes: list) -> dict:
    """Kernel 2 on what one full-width file gave it: the launches' shapes in
    the order worked out beforehand, and each launch's own output equal to
    `aa_snakebeta_ref` on its own input to the bit (float32, the whole
    signal). Returns the largest error and, for the timing phase, the first
    input of each shape with that shape's launch count."""
    from amphion_tpu_torch.ops.kernels import aa_snake as aa_mod

    shapes = [tuple(c[0].shape) for c in calls]
    check("aa_snake on the path: launches of one 10 s file", shapes == want_shapes,
          f"{len(shapes)} launches at {sorted(set(shapes))} (want {len(want_shapes)} in the "
          "order of the generator's activations)")
    worst, worst_rel, reps = 0.0, 0.0, {}
    for x, alpha, beta, out in calls:
        ref = aa_mod.aa_snakebeta_ref(x, alpha, beta)
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not torch.equal(out, ref) or out.dtype != torch.float32:
            check(f"aa_snake on the path {tuple(x.shape)}", False,
                  f"{out.dtype}, max|err| {err:.3g} of {scale:.3g} (want bit-equal)")
        worst, worst_rel = max(worst, err), max(worst_rel, err / scale)
        shape = tuple(x.shape)
        if shape not in reps:
            reps[shape] = [(x, alpha, beta), 0]
        reps[shape][1] += 1
    check("aa_snake on the path: every launch against its plain version", True,
          f"{len(calls)} launches, each bit-equal (max|err| {worst:.3g})")
    return {"max_abs_err": worst, "max_rel_err": worst_rel,
            "inputs": {k: tuple(v) for k, v in reps.items()}}


def perturb_generator(gen, seed: int) -> None:
    """Random weight-norm scales, biases and log-scale Snake parameters, so
    a generator drawn by `init_like_flax` (scales 1, biases and log alpha 0)
    exercises every parameter."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in gen.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                v = rng.uniform(0.5, 1.0, p.shape)
            elif leaf in ("bias", "alpha", "beta"):
                v = 0.1 * rng.standard_normal(p.shape)
            else:
                continue
            p.copy_(torch.from_numpy(v.astype(np.float32)))


def vocoder_reference_phase(seed: int) -> None:
    """A small float32 BigVGAN (2 stages, 64 channels, the egs resblocks) on
    the card against the same on the CPU, with the fused activation
    (kernel 2 against its plain version) and with the unfused chain: the
    waveforms within 1e-4 absolute (TF32 off)."""
    import dataclasses

    from amphion_tpu_torch.models.vocoders.bigvgan import BigVGANConfig, BigVGANGenerator
    from amphion_tpu_torch.utils.convert import init_like_flax

    cfg = BigVGANConfig(upsample_rates=(5, 4), upsample_kernel_sizes=(10, 8),
                        upsample_initial_channel=64)
    mel = torch.from_numpy(np.random.default_rng(seed + 43).standard_normal((2, 50, 80))
                           .astype(np.float32))
    for pallas in (True, False):
        gen = BigVGANGenerator(dataclasses.replace(cfg, use_pallas_act=pallas)).eval()
        init_like_flax(gen, torch.Generator().manual_seed(seed))
        perturb_generator(gen, seed)
        with torch.no_grad():
            ref = gen(mel)
            out = gen.to(DEV)(mel.to(DEV)).cpu()
        err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
        check(f"reference: small BigVGAN use_pallas_act={pallas}, card vs CPU",
              out.shape == ref.shape == (2, 50 * 20) and err <= 1e-4 and scale > 1e-3,
              f"max|err| {err:.3g} (tol 1e-4), max|ref| {scale:.3g}")


def vocoder_phase(seed: int, kernels: dict) -> dict:
    """BigVGAN copy synthesis at the full width of the egs config through the
    normal entry point, `amphion_tpu_torch.bins.vocoder.inference.main`, in
    ``from_audio`` mode: random weights from the seed (Flax initializers,
    perturbed) written with `save_generator`, one warm-up file, then six
    files of 2-10 s. Checks each wav (finite, floor(T/120)*120 samples) and
    the launch counts worked out beforehand (kernel 2: 73 per file, kernel
    3: 1 per file, no other). Then it runs the six files again (each length
    now seen: cuDNN has its plans), runs the 10 s file once more with
    kernel 2's calls recorded and holds each of its 73 launches against the
    plain version on its own input (`aa_path_check`), profiles one file at
    a seen length and one at a new length, and times one batched forward at
    the egs training shape (16 x 64 frames), fused and unfused."""
    import dataclasses
    import shutil
    import tempfile
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from amphion_tpu_torch.bins.vocoder.inference import main as infer_main
    from amphion_tpu_torch.bins.vocoder.inference import synthesize_file
    from amphion_tpu_torch.data.audio_io import load_wav, save_wav
    from amphion_tpu_torch.ops.mel import MelConfig
    from amphion_tpu_torch.runtime.vocoder_trainer import (
        build_generator, restore_generator, save_generator)
    from amphion_tpu_torch.utils.config import load_config
    from amphion_tpu_torch.utils.convert import init_like_flax

    cfg = load_config(VOC_CONFIG)
    gen, hop = build_generator(cfg, 80)
    check("vocoder config", gen.cfg.use_pallas_act and hop == HOP
          and gen.cfg.upsample_initial_channel == 512,
          f"use_pallas_act {gen.cfg.use_pallas_act}, hop {hop}, "
          f"{gen.cfg.upsample_initial_channel} channels, rates {gen.cfg.upsample_rates}")
    gen = gen.to(DEV).eval()
    init_like_flax(gen, torch.Generator(DEV).manual_seed(seed))
    perturb_generator(gen, seed)
    n_params = sum(p.numel() for p in gen.parameters())
    root = Path(tempfile.mkdtemp(prefix="bigvgan_"))
    rng = np.random.default_rng(seed + 47)
    try:
        ckpt = save_generator(root / "ckpt", gen, epoch=1, step=1)
        lengths = {}
        for name, secs in [("warm/w", (3.0,)), ("wav/f", VOC_SECONDS),
                           ("ten/t", (max(VOC_SECONDS),)), ("new/n", (9.3,))]:
            for i, s in enumerate(secs):
                path = root / f"{name}{i}.wav"
                save_wav(path, synth_audio(rng, s), SR)
                lengths[path.name] = len(load_wav(path)[0])

        def run(wav_dir, out_dir):
            return infer_main(["--config", VOC_CONFIG, "--checkpoint_path", ckpt,
                               "--output_dir", str(root / out_dir), "--mode", "from_audio",
                               "--audio_dir", str(root / wav_dir)])

        t0 = time.perf_counter()
        run("warm", "out_warm")
        log(f"vocoder: full-width BigVGAN ({n_params / 1e6:.2f} M params, float32, "
            f"use_pallas_act) warm-up file in {time.perf_counter() - t0:.2f} s")
        for k in kernels.values():
            k.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        records = run("wav", "out")
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = len(VOC_SECONDS)
        check("vocoder files", len(records) == n, f"{len(records)} written (want {n})")
        for r in records:
            wav, sr = load_wav(r["path"])
            want = lengths[Path(r["path"]).name] // HOP * HOP
            check(f"vocoder {Path(r['path']).name}", sr == SR and r["samples"] == want
                  and wav.shape == (want,) and np.isfinite(wav).all() and np.abs(wav).max() > 0,
                  f"{r['samples']} samples (want {want}), finite")
        want = {name: 0 for name in kernels}
        want.update(aa_snake=AA_PER_FORWARD * n, mel=n)
        check("vocoder launches", launches == want,
              f"{launches} (predicted {want}: {AA_PER_FORWARD} activations and 1 mel per file)")
        audio_s = sum(r["samples"] for r in records) / SR
        synth_s = sum(r["seconds"] for r in records)
        perf = {"files": n, "audio_s_out": audio_s, "main_wall_s": wall,
                "synthesis_s": synth_s, "audio_s_per_s": audio_s / synth_s,
                "audio_s_per_s_with_load": audio_s / wall,
                "latency_s": {Path(r["path"]).name: r["seconds"] for r in records},
                "max_memory_allocated_gib": peak}
        log("vocoder perf: " + json.dumps(perf))

        # the same six files again: every input shape now has its cuDNN plans
        again = run("wav", "out_again")
        synth2 = sum(r["seconds"] for r in again)
        perf2 = {"synthesis_s": synth2, "audio_s_per_s": audio_s / synth2,
                 "latency_s": {Path(r["path"]).name: r["seconds"] for r in again}}
        log("vocoder perf, second pass over the same files: " + json.dumps(perf2))

        # the 10 s file once more through the CLI, kernel 2's calls recorded:
        # every launch against its plain version on the input the path gave it
        rec = AARecorder()
        try:
            run("ten", "out_rec")
        finally:
            rec.remove()
        frames = lengths["t0.wav"] // HOP
        aa_path = aa_path_check(rec.calls, aa_file_shapes(gen.cfg, frames))
        aa_path["frames"] = frames
        del rec
        torch.cuda.empty_cache()

        # one file under the profiler, through `synthesize_file` with the
        # generator restored as `main` restores it: first at a length the
        # runs above planned (10 s), then at a new one
        mel_cfg = MelConfig.from_preprocess_cfg(cfg["preprocess"])
        gen_r = restore_generator(cfg, ckpt, mel_cfg.n_mel, torch.device(DEV))[0]
        trace = {}
        for label, wav in (("seen_length", root / "ten" / "t0.wav"),
                           ("new_length", root / "new" / "n0.wav")):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                # one small kernel first: the mel kernel, first in the file,
                # was missing from an earlier trace of this window
                torch.ones(1, device=DEV).add_(1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                synthesize_file(gen_r, wav, mel_cfg, root / f"prof_{label}.wav", DEV)
                torch.cuda.synchronize()
                file_s = time.perf_counter() - t0
            groups = {name: 0.0 for name, _ in VOC_GROUPS}
            groups.update(conv=0.0, other=0.0)
            by_name, n_rec = device_us_by_name(prof)
            for name, us in by_name.items():
                group = next((gname for gname, pat in VOC_GROUPS if pat in name), None)
                if group is None:
                    group = "conv" if any(t in name.lower() for t in CONV_NAMES) else "other"
                groups[group] += us
            busy = sum(groups.values()) / 1e6
            top = sorted(((us, nm[:80]) for nm, us in by_name.items()), reverse=True)
            trace[label] = {
                "audio_s": lengths[wav.name] / SR, "file_s": file_s, "device_busy_s": busy,
                "device_busy_share": busy / file_s, "device_records": n_rec,
                "by_group_s": {k: v / 1e6 for k, v in groups.items()},
                "top_kernels_ms": [[nm, us / 1e3] for us, nm in top[:8]]}
        log("vocoder trace (profiled files): " + json.dumps(trace))

        # one batched forward at the egs training shape, fused and unfused
        mel16 = torch.randn((16, 64, 80), generator=torch.Generator(DEV).manual_seed(seed),
                            device=DEV)
        plain = dataclasses.replace(gen.cfg, use_pallas_act=False)
        gen_chain = type(gen)(plain).to(DEV).eval()
        gen_chain.load_state_dict(gen.state_dict())
        with torch.no_grad():
            kernels["aa_snake"].reset()
            fused = gen(mel16)
            torch.cuda.synchronize()
            per_fwd = kernels["aa_snake"].launches
            chain = gen_chain(mel16)
            diff = (fused - chain).abs().max().item()
            f_ms = gpu_ms(lambda: gen(mel16), iters=10)
            c_ms = gpu_ms(lambda: gen_chain(mel16), iters=10)
        check("vocoder batched forward", per_fwd == AA_PER_FORWARD and fused.shape == (16, 64 * HOP)
              and bool(torch.isfinite(fused).all()),
              f"{per_fwd} kernel-2 launches (want {AA_PER_FORWARD}), shape {tuple(fused.shape)}; "
              f"fused vs unfused max|diff| {diff:.3g} (edge pads differ)")
        batch = {"fused_ms": f_ms, "unfused_ms": c_ms, "fused_vs_unfused_max_diff": diff,
                 "audio_s_per_s_fused": 16 * 64 * HOP / SR / (f_ms / 1e3)}
        log(f"vocoder batched forward (16, 64, 80) ({nvidia_smi()}): " + json.dumps(batch))
        return {"launches": launches, "perf": perf, "perf2": perf2, "trace": trace,
                "batch": batch, "aa_path": aa_path}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def snake_timing_phase(voc: dict, errs: dict, kernels: dict) -> list:
    """Kernels 1 and 2, float32.

    Kernel 2 at the shapes one 10 s file gave it through the CLI (batch 1;
    the inputs `aa_path_check` kept, one per shape), the row's times the
    mean per launch over the file's 73; again at the egs training batch's
    AMP shapes as an extra. No single PyTorch call computes it, so
    ``library_ms`` is null and its unfused chain through cuDNN stands
    beside it as the nearest library figure (``unfused_chain_ms``). Kernel
    1 is driven on its own through ``Snake(use_pallas=True)``, forward and
    backward once at each AMP shape (no model path runs it; the counts are
    reset before and read after), then timed per shape, on one input set
    (which stays in L2 between calls) and on four in turn (``ms_streaming``,
    from device memory). Every time is the
    device time of a CUDA-graph replay of many calls (`graph_ms`): launched
    one by one from Python, kernels this small wait on the host. Bounds:
    bytes (x read, out written; kernel 1's backward also g) over 3.35 TB/s,
    or the operations of AA_OPS / SNAKE_OPS / SNAKE_BWD_OPS per element
    over 67 TFLOP/s float32, the larger."""
    from amphion_tpu_torch.modules.activations import Snake
    from amphion_tpu_torch.ops.kernels import aa_snake as aa_mod
    from amphion_tpu_torch.ops.kernels import snake as snake_mod

    g = torch.Generator(DEV).manual_seed(53)
    snake_k = kernels["snake"]
    snake_k.reset()
    for b, t, c in AMP_SHAPES:
        m = Snake(c, use_pallas=True).to(DEV)
        x = torch.randn((b, t, c), generator=g, device=DEV, requires_grad=True)
        m(x).backward(torch.randn((b, t, c), generator=g, device=DEV))
    torch.cuda.synchronize()
    driven = dict(snake_k.tagged)
    check("snake launches through Snake(use_pallas=True)",
          driven == {"fwd": len(AMP_SHAPES), "bwd": len(AMP_SHAPES)},
          f"{driven} (want one forward and one backward at each of {len(AMP_SHAPES)} shapes)")

    def row(shape, times, ops, nbytes):
        k_ms, p_ms, *lib = times
        t_ops, t_bytes = ops / PEAK_F32, nbytes / HBM
        return {"shape": list(shape), "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                **({"unfused_chain_ms": lib[0]} if lib else {})}

    def aa_times(x, alpha, beta):
        return (graph_ms(lambda: aa_mod.aa_snakebeta(x, alpha, beta)),
                graph_ms(lambda: aa_mod.aa_snakebeta_ref(x, alpha, beta), iters=5),
                graph_ms(lambda: aa_mod.aa_snakebeta_chain(x, alpha, beta)))

    def aa_bytes(b, t, c):
        return 8.0 * b * t * c + 8 * c + 112  # x, out, alpha, beta, taps

    per_shape = {"aa_snake": [], "aa_snake_training": [], "snake": [], "snake_bwd": []}
    path = voc["aa_path"]
    with torch.no_grad():
        for shape, ((x, alpha, beta), _) in path["inputs"].items():
            per_shape["aa_snake"].append(row(shape, aa_times(x, alpha, beta),
                                             AA_OPS * x.numel(), aa_bytes(*shape)))
    for b, t, c in AMP_SHAPES:
        n = b * t * c
        x = torch.randn((b, t, c), generator=g, device=DEV) * 3
        gout = torch.randn((b, t, c), generator=g, device=DEV)
        alpha, beta = (torch.rand((c,), generator=g, device=DEV) + 0.5 for _ in range(2))
        with torch.no_grad():
            per_shape["aa_snake_training"].append(row((b, t, c), aa_times(x, alpha, beta),
                                                      AA_OPS * n, aa_bytes(b, t, c)))
            per_shape["snake"].append(row((b, t, c), (
                graph_ms(lambda: snake_mod.snake(x, alpha)),
                graph_ms(lambda: snake_mod.snake_ref(x, alpha))), SNAKE_OPS * n, 8.0 * n + 4 * c))
            per_shape["snake_bwd"].append(row((b, t, c), (
                graph_ms(lambda: snake_mod.snake_bwd(x, alpha, gout)),
                graph_ms(lambda: snake_mod.snake_bwd_ref(x, alpha, gout))),
                SNAKE_BWD_OPS * n, 12.0 * n + 8 * c))
            # the same calls over four input sets in turn: one set (at most
            # 47 MB moved) stays in the 50 MB L2 between graph-replayed calls
            sets = [(x, gout)] + [(torch.randn_like(x), torch.randn_like(x)) for _ in range(3)]
            per_shape["snake"][-1]["ms_streaming"] = graph_ms(
                lambda: [snake_mod.snake(xs, alpha) for xs, _ in sets]) / len(sets)
            per_shape["snake_bwd"][-1]["ms_streaming"] = graph_ms(
                lambda: [snake_mod.snake_bwd(xs, alpha, gs) for xs, gs in sets]) / len(sets)
    card = nvidia_smi()
    for key, rows in per_shape.items():
        log(f"timing {key} ({card}), float32 per shape: " + json.dumps(rows))

    def mean(rows, field, weights):
        vals = [r[field] for r in rows]
        return None if None in vals else sum(a * v for a, v in zip(weights, vals)) / sum(weights)

    def by(rows):
        return max(("bytes", "operations"), key=lambda k: sum(r["bound_by"] == k for r in rows))

    path_w = [n for _, n in path["inputs"].values()]
    train = per_shape["aa_snake_training"]
    aa = per_shape["aa_snake"]
    out = [_row("aa_snake", "aa_snake.cu", 270, voc["launches"]["aa_snake"], path["max_abs_err"],
                mean(aa, "ms", path_w), mean(aa, "plain_ms", path_w),
                mean(aa, "bound_ms", path_w), by(aa), None,
                unfused_chain_ms=mean(aa, "unfused_chain_ms", path_w),
                unfused_chain="depthwise conv_transpose1d (cuDNN), torch.sin, depthwise "
                              "conv1d (cuDNN), float32",
                ms_is=f"mean per launch over the 73 of one {path['frames']}-frame (10 s) "
                      "file through the CLI, batch 1, at the inputs the path gave",
                max_rel_err=path["max_rel_err"],
                max_abs_err_random_inputs=errs["aa_snake"],
                per_file_launches=AA_PER_FORWARD, per_shape=aa,
                training_batch={"ms": mean(train, "ms", AMP_LAUNCHES),
                                "plain_ms": mean(train, "plain_ms", AMP_LAUNCHES),
                                "bound_ms": mean(train, "bound_ms", AMP_LAUNCHES),
                                "unfused_chain_ms": mean(train, "unfused_chain_ms", AMP_LAUNCHES),
                                "ms_is": "mean per launch over one forward's 73 at the egs "
                                         "training batch (16 x 64 frames)",
                                "per_shape": train})]
    for key, line, tag in (("snake", 40, "fwd"), ("snake_bwd", 47, "bwd")):
        rows = per_shape[key]
        w = [1] * len(rows)
        out.append(_row(key, "snake.cu", line, driven.get(tag, 0), errs[key],
                        mean(rows, "ms", w), mean(rows, "plain_ms", w), mean(rows, "bound_ms", w),
                        by(rows), None, per_shape=rows, ms_is="mean over the four AMP shapes, "
                        "one input set (it stays in L2 from call to call)",
                        ms_streaming=mean(rows, "ms_streaming", w),
                        ms_streaming_is="the same over four input sets in turn, from device "
                                        "memory",
                        via="pallas_kernels.py:78",
                        launches_are="Snake(use_pallas=True) forward and backward once at each "
                                     "AMP shape; no model path runs kernel 1",
                        vocoder_path_launches=voc["launches"]["snake"]))
    return out


# -- GAN vocoder training: bins/vocoder/train.py (kernels 2 and 3 under grad) ------

GAN_STEPS, GAN_SAVE = 8, 4
GAN_CLIPS = 32  # 0.5-1 s each: longer than a 64-frame segment, so crops are drawn
GAN_MEL_PER_STEP = 3  # the batch's conditioning mel, mel_loss's real and (LogMelFn) fake
GAN_LARGE_CONFIG = "egs/vocoder/gan/bigvgan_large/exp_config.json"
GAN_LARGE_AA_PER_FORWARD = 6 * 18 + 1  # six stages of 18 activations, plus the last
GAN_LARGE_STEPS = 2
GAN_KEYS = ("d_loss", "g_loss", "g_adv", "g_fm", "g_mel")
# operations per element of kernel 2's backward as the step runs it (autograd
# of the unfused chain, `AASnakeBetaFn.backward`): the up FIRs recomputed (24),
# the activation and its derivative in x, alpha and beta on both phases
# (2 x 12), the transposed down FIR (24) and up FIR (24)
AA_BWD_OPS = 96
GAN_GROUPS = [("aa_snake", "aa_snake_kernel"), ("mel", "mel_kernel"),
              ("adamw", "multi_tensor_apply")]
# the small float32 GAN held card vs CPU (the mel kernel takes n_fft 256 to 2048)
GAN_SMALL = {
    "mel": dict(sample_rate=16000, n_fft=256, win_size=128, hop_size=16, n_mel=32, fmax=8000),
    "gen": dict(n_mel=32, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                resblock_dilation_sizes=((1, 3),), use_pallas_act=True),
    "disc": dict(use=("mpd", "msd", "mrd"), mpd_periods=(2, 3), msd_scales=2,
                 channel_mult=0.25, mrd_resolutions=((256, 32, 128),)),
}


def gan_corpus(root, seed: int, n: int = GAN_CLIPS) -> None:
    """``n`` 24 kHz clips of 0.5-1 s and their train.json."""
    from amphion_tpu_torch.data.audio_io import save_wav
    from amphion_tpu_torch.data.metadata import Utterance, save_metadata

    rng = np.random.default_rng(seed + 41)
    utts = []
    for i in range(n):
        sec = float(rng.uniform(0.5, 1.0))
        path = root / "wav" / f"{i:02d}.wav"
        save_wav(path, synth_audio(rng, sec), SR)
        utts.append(Utterance("smoke", f"clip{i:02d}", str(path), sec))
    save_metadata(root / "data" / "smoke" / "train.json", utts)


def gan_config(root, name: str, base: str = VOC_CONFIG, model: dict | None = None,
               **train) -> str:
    """``base`` (an egs vocoder recipe, at its width and batch) over the
    smoke corpus, with a log dir and a metrics file under ``root``, the
    ``model`` overrides and the ``train`` ones."""
    cfg = {"base_config": os.path.abspath(base), "dataset": ["smoke"],
           "log_dir": str(root / "ckpts"), "preprocess": {"processed_dir": str(root / "data")},
           "model": model or {},
           "train": {"log_interval": 1, "metrics_path": str(root / f"{name}.jsonl"), **train}}
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def gan_launches(kernels: dict, steps: int, aa_per_forward: int = AA_PER_FORWARD):
    """The run's launch counts against those worked out beforehand: kernel 2
    in both generator forwards of a step, kernel 3 three times a step, no
    other kernel (each epoch's batches are all consumed)."""
    got = {name: k.launches for name, k in kernels.items()}
    want = {name: 0 for name in kernels}
    want.update(aa_snake=2 * aa_per_forward * steps, mel=GAN_MEL_PER_STEP * steps)
    return got == want, f"{got} (predicted {want}: {steps} steps)"


class GANBackwards:
    """While active, the backward of `AASnakeBetaFn` (kernel 2's: autograd
    of the unfused chain) and of `LogMelFn` (kernel 3's: autograd of
    `log_mel_ref`) each run in a ``record_function`` range (``aa_chain_bwd``,
    ``mel_bwd``), where the profiler finds their device time; with
    ``record`` the inputs and gradients of every LogMelFn call and of the
    first AASnakeBetaFn call at each shape are kept."""

    RANGES = {"AASnakeBetaFn": "aa_chain_bwd", "LogMelFn": "mel_bwd"}

    def __init__(self, record: bool = False):
        self.record = record
        self.mel, self.aa = [], {}

    def __enter__(self) -> "GANBackwards":
        from amphion_tpu_torch.ops.kernels.aa_snake import AASnakeBetaFn
        from amphion_tpu_torch.ops.kernels.mel import LogMelFn

        self.saved = []
        for cls in (AASnakeBetaFn, LogMelFn):
            orig = cls.__dict__["backward"]
            self.saved.append((cls, orig))
            cls.backward = staticmethod(functools.partial(self._backward, orig.__func__,
                                                          cls.__name__))
        return self

    def __exit__(self, *exc) -> None:
        for cls, orig in self.saved:
            cls.backward = orig

    def _backward(self, fn, kind: str, ctx, g):
        saved = ctx.saved_tensors
        with torch.profiler.record_function(self.RANGES[kind]):
            grads = fn(ctx, g)
        if self.record:
            keep = [t.detach().clone() for t in saved]
            if kind == "LogMelFn":
                self.mel.append((keep[0], g.detach().clone(), grads[0].detach().clone(),
                                 ctx.args))
            elif tuple(keep[0].shape) not in self.aa:
                self.aa[tuple(keep[0].shape)] = (keep, g.detach().clone())
        return grads


def gan_profile(trainer, batches: list, median_step_s: float) -> dict:
    """Steps of ``trainer`` on ``batches`` (made beforehand) under
    torch.profiler (host and device activity, the backward ranges of
    `GANBackwards`): wall, device-busy share (of the profiled wall and of
    the unprofiled median step) and device time by group: cuDNN
    convolutions, kernel 2, its chain backward, kernel 3, the mel backward,
    the AdamW updates and the other (elementwise, reductions, copies)."""
    from torch.profiler import ProfilerActivity, profile

    states = trainer.loop.states
    torch.cuda.synchronize()
    with GANBackwards(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            states, _ = trainer.loop.train_step(states, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device records: kernels, copies and sets; the GPU-side spans of host
    # ranges (record_function, the optimizer's step) carry a host op's name
    # and are left out, and a record the trace lists twice counts once
    host_names = {e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU}
    spans, seen, streams = [], set(), {}
    for e in prof.profiler.kineto_results.events():
        key = (e.name(), e.start_ns(), e.duration_ns())
        if (e.device_type() == torch.autograd.DeviceType.CUDA and e.name() not in host_names
                and key not in seen):
            seen.add(key)
            spans.append(key)
            sid = str(e.device_resource_id()) if hasattr(e, "device_resource_id") else "?"
            rec = streams.setdefault(sid, [0, 0.0])
            rec[0] += 1
            rec[1] += e.duration_ns() / 1e6
    by_name = {}
    for name, _, dur in spans:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e3
    # the busy time is the union of the records' intervals; where records
    # overlap (other streams), the part of each that starts under an earlier
    # one is counted by kernel name
    union_ns, end, overlap = 0, -1, {}
    for name, start, dur in sorted(spans, key=lambda x: x[1]):
        if start < end:
            overlap[name] = overlap.get(name, 0.0) + (min(end, start + dur) - start) / 1e6
        if start + dur > end:
            union_ns += start + dur - max(start, end)
            end = start + dur
    n_records = len(spans)
    in_range = {name: {} for name in GANBackwards.RANGES.values()}

    def collect(evt, acc):
        for k in evt.kernels:
            acc[k.name] = acc.get(k.name, 0.0) + k.duration
        for ch in evt.cpu_children:
            collect(ch, acc)

    for evt in prof.events():
        if evt.name in in_range:
            collect(evt, in_range[evt.name])
    groups = {"convolutions": 0.0, "aa_snake": 0.0, "aa_chain_bwd": 0.0, "mel": 0.0,
              "mel_bwd": 0.0, "adamw": 0.0, "other": 0.0}
    rest = dict(by_name)
    for rng_name, acc in in_range.items():
        for name, us in acc.items():
            groups[rng_name] += us
            rest[name] = rest.get(name, 0.0) - us
    for name, us in rest.items():
        group = next((g for g, pat in GAN_GROUPS if pat in name), None)
        if group is None:
            group = ("convolutions" if any(t in name.lower() for t in CONV_NAMES)
                     else "other")
        groups[group] += us
    n = len(batches)
    busy = union_ns / 1e9  # the time at least one device record ran
    total = sum(groups.values()) / 1e6
    check("gan trace", busy > 0 and all(groups[r] > 0 for r in in_range),
          f"device busy {busy:.4g} s (records summed {total:.4g} s) in {n_records} records; "
          "the backward ranges " + ", ".join(f"{r} {groups[r] / 1e3:.3f} ms" for r in in_range))
    top = sorted(((us, nm[:80]) for nm, us in by_name.items()), reverse=True)
    return {"steps": n, "wall_s": wall, "device_busy_s": busy, "device_records_summed_s": total,
            "device_busy_share": busy / wall,
            "device_busy_share_of_median_step": busy / n / median_step_s,
            "device_records": n_records,
            "per_step_ms": {k: v / 1e3 / n for k, v in groups.items()},
            "share_of_device_time": {k: v / 1e6 / max(total, 1e-12) for k, v in groups.items()},
            "top_kernels_ms": [[nm, us / 1e3 / n] for us, nm in top[:8]],
            "streams": {k: {"records": v[0], "ms_per_step": v[1] / n}
                        for k, v in streams.items()},
            "overlapped_ms_per_step": sorted(([nm[:80], ms / n] for nm, ms in overlap.items()),
                                             key=lambda x: -x[1])[:6]}


def gan_backward_timing(rec: GANBackwards, mel_cfg) -> dict:
    """Kernel 3 forward at the step's (16, 7680) and both backwards on the
    path's own inputs (the recorded calls), by CUDA-graph replays of
    ``torch.autograd.grad`` on a retained graph (its forward run on the
    capture stream), or by the profiler where a capture fails: the mel
    backward (`LogMelFn.backward`: `log_mel_ref` recomputed and
    differentiated) and kernel 2's chain backward at each of the four AMP
    shapes, mean per launch over a forward's 73. Bounds: bytes over 3.35
    TB/s or operations over 67 TFLOP/s float32, the larger; the mel
    backward counts y, the cotangent and dy once and twice the forward's
    operations, the chain backward x, g and dx once and AA_BWD_OPS an
    element."""
    from amphion_tpu_torch.ops.kernels.aa_snake import AASnakeBetaFn
    from amphion_tpu_torch.ops.mel import _fbank, mel_spectrogram, mel_spectrogram_ref

    def bwd_ms(make):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out, leaves, g = make()
        torch.cuda.current_stream().wait_stream(side)
        grad = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)  # noqa: E731
        try:
            return graph_ms(grad, iters=10, stream=side), "graph replays"
        except Exception as exc:  # noqa: BLE001 - the profiler measures it instead
            log(f"  backward capture failed ({type(exc).__name__}: {exc}); profiler time")
            torch.cuda.synchronize()
            return profiled_ms(grad), "profiler"

    y, g, _, _ = rec.mel[0]
    b, t = y.shape
    fb = _fbank(mel_cfg, y.device)
    flops_row, _, _ = mel_work([t], fb)
    with torch.no_grad():
        fwd_ms = graph_ms(lambda: mel_spectrogram(y, mel_cfg))
        plain_ms = graph_ms(lambda: mel_spectrogram_ref(y, mel_cfg), iters=5)
        lib_ms = graph_ms(lambda: library_mel(y, fb, mel_cfg.clip_val))
    fwd_bytes = 4.0 * (b * t + g.numel())
    fwd_bound = max(b * flops_row / PEAK_F32, fwd_bytes / HBM) * 1e3

    def mel_leaves():
        leaf = y.clone().requires_grad_()
        return mel_spectrogram(leaf, mel_cfg), [leaf], g

    m_ms, m_how = bwd_ms(mel_leaves)
    m_ops, m_bytes = 2.0 * b * flops_row, 4.0 * (2 * b * t + g.numel())
    mel = {"shape": [b, t], "forward_ms": fwd_ms, "forward_plain_ms": plain_ms,
           "forward_library_ms": lib_ms,
           "forward_bound_ms": fwd_bound,
           "backward": {"ms": m_ms, "timing": m_how, "bound_ms": max(m_ops / PEAK_F32,
                                                                     m_bytes / HBM) * 1e3,
                        "bound_by": "operations" if m_ops / PEAK_F32 >= m_bytes / HBM
                        else "bytes", "library_ms": None}}
    per_shape = []
    for shape, launches in zip(AMP_SHAPES, AMP_LAUNCHES):
        (x, alpha, beta), gx = rec.aa[shape]

        def aa_leaves(x=x, alpha=alpha, beta=beta, gx=gx):
            leaves = [x.clone().requires_grad_(), alpha.clone().requires_grad_(),
                      beta.clone().requires_grad_()]
            return AASnakeBetaFn.apply(*leaves), leaves, gx

        ms, how = bwd_ms(aa_leaves)
        n = x.numel()
        t_ops, t_bytes = AA_BWD_OPS * n / PEAK_F32, (12.0 * n + 16 * shape[2]) / HBM
        per_shape.append({"shape": list(shape), "ms": ms, "timing": how,
                          "bound_ms": max(t_ops, t_bytes) * 1e3,
                          "bound_by": "operations" if t_ops >= t_bytes else "bytes"})
    w = AMP_LAUNCHES
    aa = {"ms": sum(a * r["ms"] for a, r in zip(w, per_shape)) / sum(w),
          "bound_ms": sum(a * r["bound_ms"] for a, r in zip(w, per_shape)) / sum(w),
          "bound_by": max(("bytes", "operations"),
                          key=lambda k: sum(r["bound_by"] == k for r in per_shape)),
          "library_ms": None, "per_shape": per_shape,
          "ms_is": "mean per launch over a forward's 73 at the step's AMP shapes"}
    return {"mel": mel, "aa_chain_bwd": aa}


def gan_train_phase(seed: int, kernels: dict) -> dict:
    """BigVGAN GAN training at the width and batch of
    egs/vocoder/gan/bigvgan/exp_config.json (512 channels, MPD + MSD, 16 x
    64 frames) through the normal entry point,
    `amphion_tpu_torch.bins.vocoder.train.main`, on a synthetic corpus: 8
    steps in float32 with a checkpoint at step 4, then a resume from it that
    must repeat steps 5-8's losses within 1e-5 relative; the launch counts
    of both runs against the counts worked out beforehand (set to 0 just
    before each run, read just after); a recorded step (LogMelFn on its own
    input: the forward held to float64 within 1e-3 or no further than
    `log_mel_ref`, the gradient equal to autograd of `log_mel_ref` to the
    bit), two profiled steps, the backwards timed, and the trained
    checkpoint read back through `restore_generator` and the vocoder
    inference CLI. cuDNN runs deterministic algorithms throughout
    (``cudnn.deterministic``): with its defaults (the step's weight
    gradients ran `wgrad_alg0_engine`, an algorithm that sums with atomics)
    the resumed losses moved by 2e-7 to 8.6e-6 relative in 4 steps, too
    near the check's 1e-5 for the check to test the resume."""
    import shutil
    import tempfile
    from pathlib import Path

    from amphion_tpu_torch.bins.vocoder import inference
    from amphion_tpu_torch.bins.vocoder.train import main as train_main
    from amphion_tpu_torch.data.audio_io import load_wav
    from amphion_tpu_torch.ops.kernels.mel import log_mel, log_mel_f64, log_mel_ref
    from amphion_tpu_torch.ops.mel import _fbank
    from amphion_tpu_torch.runtime.vocoder_trainer import restore_generator
    from amphion_tpu_torch.utils.config import load_config

    root = Path(tempfile.mkdtemp(prefix="gan_"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gan_corpus(root, seed)
        cfg = gan_config(root, "run", max_steps=GAN_STEPS, save_checkpoints_steps=GAN_SAVE)
        for k in kernels.values():
            k.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = train_main(["--config", cfg, "--exp_name", "run"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches_ok, launches_detail = gan_launches(kernels, GAN_STEPS)
        launches = {name: k.launches for name, k in kernels.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        states = trainer.loop.states
        n_g, n_d = (sum(p.numel() for p in states[s].model.parameters()) for s in ("g", "d"))
        rows = metrics(root, "run")
        log(f"gan train: BigVGAN {n_g / 1e6:.2f} M + MPD/MSD {n_d / 1e6:.2f} M params, "
            f"float32 (cuDNN deterministic), batch {trainer.batch_size} x {trainer.dataset.segment_samples} samples; "
            f"{GAN_STEPS} steps in {wall:.1f} s (build and checkpoints included); losses "
            + json.dumps([{k: r[k] for k in GAN_KEYS} for r in rows]))
        check("gan train losses", len(rows) == GAN_STEPS and all(
            math.isfinite(r[k]) for r in rows for k in GAN_KEYS), f"{len(rows)} steps finite")
        check("gan train launches", launches_ok, launches_detail)
        med = statistics.median(r["step_s"] for r in rows[2:])
        samples = trainer.batch_size * trainer.dataset.segment_samples
        perf = {"median_step_s": med, "step_s": [r["step_s"] for r in rows],
                "audio_samples_per_s": samples / med, "audio_s_per_s": samples / med / SR,
                "max_memory_allocated_gib": peak}
        log(f"gan train perf ({nvidia_smi()}): median step {med:.4f} s over steps 3-"
            f"{GAN_STEPS}, {samples / med / SR:.2f} audio s/s of training ({samples} "
            f"samples a step), peak {peak:.2f} GiB; " + json.dumps(perf))

        # the trained checkpoint (step 8): restore_generator, then the inference CLI
        ckdir = root / "ckpts" / "run" / "checkpoint"
        snap = root / "ckpts" / "run" / "exp_config.json"
        gen, _, _, step = restore_generator(load_config(snap), ckdir, 80, torch.device(DEV))
        same = all(torch.equal(a, b) for a, b in zip(
            gen.state_dict().values(), trainer.loop.states["g"].model.state_dict().values()))
        wavs = root / "infer_in"
        wavs.mkdir()
        for i in (0, 1):
            shutil.copy(root / "wav" / f"{i:02d}.wav", wavs / f"{i:02d}.wav")
        out_dir = root / "infer_out"
        recs = inference.main(["--config", str(snap), "--checkpoint_path", str(ckdir),
                               "--output_dir", str(out_dir), "--mode", "from_audio",
                               "--audio_dir", str(wavs)])
        wav_ok = []
        for r in recs:
            wav, sr = load_wav(r["path"], sr=SR)
            src, _ = load_wav(wavs / Path(r["path"]).name, sr=SR)
            wav_ok.append(sr == SR and len(wav) == len(src) // HOP * HOP
                          and bool(np.isfinite(wav).all()) and 0 < np.abs(wav).max() <= 1.0)
        check("gan checkpoint through restore_generator and bins/vocoder/inference",
              step == GAN_STEPS and same and len(recs) == 2 and all(wav_ok),
              f"step {step}, weights equal to the trainer's {same}, {len(recs)} wavs "
              f"well-formed {wav_ok}")
        del gen

        # one recorded step, then two profiled ones, on batches made beforehand
        # (each a new crop draw; the counts were read above)
        bs, n = trainer.batch_size, len(trainer.dataset)
        batches = [trainer._make_batch([(i * bs + j) % n for j in range(bs)],
                                       np.random.default_rng(seed + i)) for i in range(3)]
        with GANBackwards(record=True) as rec:
            states, _ = trainer.loop.train_step(states, batches[0])
        torch.cuda.synchronize()
        check("gan recorded step", len(rec.mel) == 1 and sorted(rec.aa) == sorted(AMP_SHAPES),
              f"{len(rec.mel)} LogMelFn backward, kernel-2 backward shapes {sorted(rec.aa)}")
        y, g, dy, args = rec.mel[0]
        fb = _fbank(trainer.mel_cfg, y.device)
        with torch.no_grad():
            out, ref = log_mel(y, fb, *args), log_mel_ref(y, fb, *args)
            f64 = log_mel_f64(y, fb, *args)
        fwd_err = (out - ref).abs().max().item()
        k64, p64 = ((x.double() - f64).abs().max().item() for x in (out, ref))
        leaf = y.clone().requires_grad_()
        (dref,) = torch.autograd.grad(log_mel_ref(leaf, fb, *args), leaf, g)
        # a generator's output early in training leaves bands of tiny energy,
        # where the log magnifies float32 rounding: both versions are held to
        # float64, the kernel within 1e-3 or no further than the plain version
        check("LogMelFn on the step's own input",
              k64 <= max(1e-3, p64) and torch.equal(dy, dref),
              f"{tuple(y.shape)}: forward (kernel 3) max|err| {fwd_err:.3g} against "
              f"log_mel_ref; against float64: kernel {k64:.3g}, log_mel_ref {p64:.3g} (tol: "
              f"the larger of 1e-3 and log_mel_ref's); gradient bit-equal to autograd of "
              f"log_mel_ref {torch.equal(dy, dref)} (max|diff| "
              f"{(dy - dref).abs().max().item():.3g})")
        prof = gan_profile(trainer, batches[1:], med)
        log(f"gan train trace ({nvidia_smi()}): " + json.dumps(prof))
        timing = gan_backward_timing(rec, trainer.mel_cfg)
        log(f"gan timing ({nvidia_smi()}): " + json.dumps(timing))
        mel_fwd_err, mel_err_f64 = fwd_err, {"kernel": k64, "log_mel_ref": p64}
        del rec, batches

        # resume from the step-4 checkpoint, in a run directory of its own
        step4 = next(p for p in ckdir.glob("epoch-*") if f"_step-{GAN_SAVE:07d}_" in p.name)
        del trainer, states
        gc.collect()
        torch.cuda.empty_cache()
        for k in kernels.values():
            k.reset()
        cfg2 = gan_config(root, "resume", max_steps=GAN_STEPS, save_checkpoints_steps=0)
        again = train_main(["--config", cfg2, "--exp_name", "resume", "--resume",
                            "--resume_from_ckpt_path", str(step4)])
        resume_ok, resume_detail = gan_launches(kernels, GAN_STEPS - GAN_SAVE)
        rerun = metrics(root, "resume")
        first = rows[GAN_SAVE:]
        rel = (max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(rerun, first) for k in GAN_KEYS)
               if rerun else math.inf)
        bit = all(a[k] == b[k] for a, b in zip(rerun, first) for k in GAN_KEYS)
        check("gan train resume", len(rerun) == len(first) and rel <= 1e-5 and resume_ok,
              f"steps {GAN_SAVE + 1}-{GAN_STEPS} from the step-{GAN_SAVE} checkpoint: max "
              f"relative difference {rel:.3g} over {GAN_KEYS} (tol 1e-5), bit-equal {bit}; "
              f"launches {resume_detail}")
        del again
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "perf": perf, "trace": prof, "timing": timing,
            "mel_fwd_err": mel_fwd_err, "mel_fwd_err_f64": mel_err_f64,
            "resume_bit_equal": bit}


def gan_large_phase(seed: int, kernels: dict) -> dict:
    """Two steps of egs/vocoder/gan/bigvgan_large/exp_config.json at its
    published width and batch (BigVGAN 1536 channels, rates 4·4·2·2·2·2;
    MPD + MRD; 8 x 32 frames of hop 256; n_fft 1024) through
    `bins/vocoder/train.main`: MRD's one run on the card. Losses finite,
    kernel 2 in both forwards of each step (109 a forward), kernel 3 three
    times a step."""
    import shutil
    import tempfile
    from pathlib import Path

    from amphion_tpu_torch.bins.vocoder.train import main as train_main

    root = Path(tempfile.mkdtemp(prefix="gan_large_"))
    try:
        gan_corpus(root, seed, n=16)
        cfg = gan_config(root, "large", base=GAN_LARGE_CONFIG, max_steps=GAN_LARGE_STEPS)
        for k in kernels.values():
            k.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = train_main(["--config", cfg, "--exp_name", "large"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ok, detail = gan_launches(kernels, GAN_LARGE_STEPS, GAN_LARGE_AA_PER_FORWARD)
        rows = metrics(root, "large")
        states = trainer.loop.states
        n_g, n_d = (sum(p.numel() for p in states[s].model.parameters()) for s in ("g", "d"))
        d_names = [type(m).__name__ for m in states["d"].model.subs]
        peak = torch.cuda.max_memory_allocated() / 2**30
        check("gan bigvgan_large steps", len(rows) == GAN_LARGE_STEPS and all(
            math.isfinite(r[k]) for r in rows for k in GAN_KEYS) and ok
            and d_names == ["MultiPeriodDiscriminator", "MultiResolutionDiscriminator"],
            f"BigVGAN {n_g / 1e6:.2f} M + {d_names} {n_d / 1e6:.2f} M params, batch "
            f"{trainer.batch_size} x {trainer.dataset.segment_samples}: losses "
            + json.dumps([{k: r[k] for k in GAN_KEYS} for r in rows])
            + f"; steps {[r['step_s'] for r in rows]} s, {wall:.1f} s with the build and "
            f"checkpoint, peak {peak:.2f} GiB; launches {detail}")
        del trainer, states
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"step_s": [r["step_s"] for r in rows], "peak_gib": peak}


def gan_step_card_vs_cpu(label: str, g, d, mel_cfg, batch: dict, gen_args=("mel",),
                         draws: dict | None = None) -> None:
    """One D-then-G step of the float32 pair (``g``, ``d``) on the card and on
    the CPU from the same weights and batch (and, for a generator that
    draws noise, the same ``draws``, given to both): every loss within 1e-4
    relative, and each updated parameter's update within 1 % of the learning
    rate of the CPU's for all but 1e-3 of the elements, none further than
    2.1 learning rates (Adam's first update is about the gradient's sign: an
    element whose gradient is near 0 may flip)."""
    import copy

    from amphion_tpu_torch.models.vocoders.gan_trainer import (
        GANTrainConfig, create_gan_states, make_gan_train_step)

    res = {}
    for dev in ("cpu", DEV):
        gd, dd = copy.deepcopy(g).to(dev), copy.deepcopy(d).to(dev)
        if draws is not None:
            on_dev = {k: v.to(dev) for k, v in draws.items()}
            gd.draw = lambda *args, generator: on_dev
        gs, ds = create_gan_states(gd, dd, GANTrainConfig())
        step = make_gan_train_step(mel_cfg, gen_args=gen_args, use_rng=draws is not None)
        _, _, m = step(gs, ds, {k: v.to(dev) for k, v in batch.items()})
        res[dev] = ({k: v.item() for k, v in m.items()},
                    [p.detach().cpu() for p in list(gd.parameters()) + list(dd.parameters())])
    rel = max(abs(res[DEV][0][k] - v) / abs(v) for k, v in res["cpu"][0].items())
    lr = GANTrainConfig().lr
    off = total = 0
    worst = 0.0
    for s, a, c in zip(list(g.parameters()) + list(d.parameters()), res[DEV][1], res["cpu"][1]):
        diff = ((a - s.detach()) - (c - s.detach())).abs()
        off += int((diff > 1e-2 * lr).sum())
        total += diff.numel()
        worst = max(worst, diff.max().item())
    check(f"reference: {label}, card vs CPU",
          rel <= 1e-4 and off <= 1e-3 * total and worst <= 2.1 * lr,
          f"losses {res[DEV][0]} vs {res['cpu'][0]} (max rel {rel:.2g}, tol 1e-4); "
          f"updates off by more than 1 % of lr: {off} of {total} (tol 1e-3), worst "
          f"{worst / lr:.3g} lr (tol 2.1)")


def perturbed_flax_init(module, gen: torch.Generator):
    """``module`` drawn by `init_like_flax`, then every parameter moved by
    0.05 standard normal noise (weight-norm scales off 1, biases off 0)."""
    from amphion_tpu_torch.utils.convert import init_like_flax

    init_like_flax(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return module


def gan_reference_phase(seed: int) -> None:
    """One D-then-G step of a small float32 GAN (BigVGAN 32 channels with
    the fused activation, MPD + MSD + MRD at a quarter width; n_fft 256)
    on the card and on the CPU from the same weights and batch
    (`gan_step_card_vs_cpu`)."""
    from amphion_tpu_torch.models.vocoders.bigvgan import BigVGANConfig, BigVGANGenerator
    from amphion_tpu_torch.models.vocoders.gan_trainer import CombinedDiscriminator
    from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram_ref

    mel_cfg = MelConfig(**GAN_SMALL["mel"])
    gen = torch.Generator().manual_seed(seed + 47)
    g = perturbed_flax_init(BigVGANGenerator(BigVGANConfig(**GAN_SMALL["gen"])), gen)
    d = perturbed_flax_init(CombinedDiscriminator(**GAN_SMALL["disc"]), gen)
    rng = np.random.default_rng(seed + 47)
    audio = torch.from_numpy(np.stack([synth_audio(rng, 0.064) for _ in range(4)])[:, :1024])
    mel = mel_spectrogram_ref(audio, mel_cfg).transpose(1, 2).contiguous()
    gan_step_card_vs_cpu("small f32 GAN step", g, d, mel_cfg, {"audio": audio, "mel": mel})


def gan_phase(seed: int, kernels: dict, rows: list) -> None:
    """The GAN training phases; kernel 2's and kernel 3's rows of the
    timing line get the training path's launches, times and backwards."""
    gan_reference_phase(seed)
    gan = gan_train_phase(seed, kernels)
    gan_large_phase(seed, kernels)
    t = gan["timing"]
    row = next(r for r in rows if r["name"] == "mel_spectrogram")
    row["gan_training"] = {
        "launches": gan["launches"]["mel"], "launches_per_step": gan["launches"]["mel"] / GAN_STEPS,
        "shape": t["mel"]["shape"], "ms": t["mel"]["forward_ms"],
        "plain_ms": t["mel"]["forward_plain_ms"], "bound_ms": t["mel"]["forward_bound_ms"],
        "library_ms": t["mel"]["forward_library_ms"], "max_abs_err": gan["mel_fwd_err"],
        "max_abs_err_vs_float64": gan["mel_fwd_err_f64"],
        "backward": {**t["mel"]["backward"],
                     "is": "LogMelFn.backward: autograd of log_mel_ref, no kernel"}}
    row = next(r for r in rows if r["name"] == "aa_snake")
    row["gan_training"] = {
        "launches": gan["launches"]["aa_snake"],
        "launches_per_step": gan["launches"]["aa_snake"] / GAN_STEPS,
        "backward": {**t["aa_chain_bwd"],
                     "is": "AASnakeBetaFn.backward: autograd of the unfused chain, no kernel"}}


# -- the GAN vocoder zoo: every egs/vocoder/gan recipe through both vocoder CLIs ---

ZOO_RECIPES = ("hifigan", "melgan", "apnet", "vocos", "nsfhifigan", "tfr_enhanced_hifigan")
ZOO_STEPS = 3
ZOO_CLIPS = 48  # three batches of 16: the three steps consume one whole epoch
ZOO_FILES = 2  # copy-synthesis files per recipe
# the apnet recipe has no model.apnet block, so APNetConfig keeps hop 256 against the
# preprocess hop of 120 and JAX's trainer fails its hop check: the base preprocess's STFT
ZOO_APNET = {"n_fft": 1024, "hop_size": 120, "win_size": 480}
# the small float32 pairs held card vs CPU (24 kHz: MS-SB-CQT's nine octaves need it)
ZOO_SMALL_MEL = dict(sample_rate=24000, n_fft=256, win_size=128, hop_size=16, n_mel=32,
                     fmax=8000)
ZOO_SMALL_HIFI = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                      upsample_initial_channel=32, resblock_kernel_sizes=(3,),
                      resblock_dilation_sizes=((1, 3),), n_mel=32)


def zoo_mel_check(trainer, seed: int) -> dict:
    """Kernel 3 on one step's own inputs: a batch's real audio and the
    generator's fake audio as the mel loss's `LogMelFn` took it (recorded by
    `GANBackwards`), each against `log_mel_ref` and float64: the kernel
    within 1e-3 of float64 or no further than `log_mel_ref` (the GAN
    phase's tolerance)."""
    from amphion_tpu_torch.ops.kernels.mel import log_mel, log_mel_f64, log_mel_ref
    from amphion_tpu_torch.ops.mel import _fbank

    bs, n = trainer.batch_size, len(trainer.dataset)
    batch = trainer._make_batch(list(range(min(bs, n))), np.random.default_rng(seed))
    with GANBackwards(record=True) as rec:
        trainer.loop.train_step(trainer.loop.states, batch)
    torch.cuda.synchronize()
    fake, _, _, args = rec.mel[0]
    fb = _fbank(trainer.mel_cfg, fake.device)
    out = {}
    with torch.no_grad():
        for name, y in (("real", batch["audio"]), ("fake", fake)):
            k, r, f64 = log_mel(y, fb, *args), log_mel_ref(y, fb, *args), log_mel_f64(y, fb, *args)
            out[name] = {"vs_log_mel_ref": (k - r).abs().max().item(),
                         "kernel_vs_float64": (k.double() - f64).abs().max().item(),
                         "log_mel_ref_vs_float64": (r.double() - f64).abs().max().item()}
    ok = all(v["kernel_vs_float64"] <= max(1e-3, v["log_mel_ref_vs_float64"])
             for v in out.values())
    return {"ok": ok, **out}


def zoo_base(recipe: str) -> tuple[str, dict | None]:
    """The egs recipe a zoo run trains and its model overrides: apnet's STFT
    (`ZOO_APNET`), and the MS-STFT run's HiFi-GAN against MPD + MS-STFT."""
    base = f"egs/vocoder/gan/{'hifigan' if recipe == 'msstft' else recipe}/exp_config.json"
    return base, {"apnet": {"apnet": ZOO_APNET},
                  "msstft": {"discriminators": ["mpd", "msstft"]}}.get(recipe)


def zoo_recipe(root, recipe: str, kernels: dict, seed: int) -> dict:
    """One egs/vocoder/gan recipe at its width and batch: ZOO_STEPS float32
    steps through `bins/vocoder/train.main` (kernel 3 three times a step, no
    other kernel), kernel 3 on a step's own real and fake audio, then copy
    synthesis of ZOO_FILES files from the last checkpoint through
    `bins/vocoder/inference.main` (kernel 3 once a file; NSF-HiFiGAN raises:
    the CLI feeds no F0)."""
    import shutil
    from pathlib import Path

    from amphion_tpu_torch.bins.vocoder import inference
    from amphion_tpu_torch.bins.vocoder.train import main as train_main
    from amphion_tpu_torch.data.audio_io import load_wav
    from amphion_tpu_torch.runtime.vocoder_trainer import step_flops

    base, model = zoo_base(recipe)
    steps = 1 if recipe == "msstft" else ZOO_STEPS
    cfg = gan_config(root, recipe, base=base, model=model, max_steps=steps)
    if recipe == "msstft":  # a one-batch epoch, so the data path makes no batch beyond it
        c = json.loads(Path(cfg).read_text())
        Path(cfg).write_text(json.dumps({**c, "dataset": ["one_batch"]}))
    if recipe == "apnet":
        log(f"  zoo apnet: the recipe has no model.apnet block (hop 256 against the "
            f"preprocess's 120, which fails JAX's hop check too); trained with "
            f"model.apnet = {ZOO_APNET}")
    for k in kernels.values():
        k.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_main(["--config", cfg, "--exp_name", recipe])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_ok, launches_detail = gan_launches(kernels, steps, aa_per_forward=0)
    mel_launches = kernels["mel"].launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    rows = metrics(root, recipe)
    states = trainer.loop.states
    n_g, n_d = (sum(p.numel() for p in states[s].model.parameters()) for s in ("g", "d"))
    d_names = [type(m).__name__ for m in states["d"].model.subs]
    check(f"zoo {recipe} train", len(rows) == steps and all(
        math.isfinite(r[k]) for r in rows for k in GAN_KEYS) and launches_ok,
        f"{type(states['g'].model).__name__} {n_g / 1e6:.2f} M + {d_names} {n_d / 1e6:.2f} M "
        f"params, batch {trainer.batch_size} x {trainer.dataset.segment_samples}: losses "
        + json.dumps([{k: r[k] for k in GAN_KEYS} for r in rows])
        + f"; launches {launches_detail}")
    step_s = [r["step_s"] for r in rows]
    samples = trainer.batch_size * trainer.dataset.segment_samples
    med = statistics.median(step_s)
    flop = step_flops(trainer.cfg)["step"] / 1e12  # of the config just trained
    out = {"generator": type(states["g"].model).__name__, "discriminators": d_names,
           "params_g_m": n_g / 1e6, "params_d_m": n_d / 1e6, "step_s": step_s,
           "median_step_s": med, "audio_s_per_s": samples / med / SR,
           "max_memory_allocated_gib": peak, "wall_s": wall, "steps": len(rows),
           "mel_launches": mel_launches,
           "conv_tflop_per_step": flop, "conv_tflop_per_s_at_median": flop / med}
    mel = zoo_mel_check(trainer, seed)
    check(f"zoo {recipe} kernel 3 on the step's audio", mel["ok"], json.dumps(mel))
    out["mel_check"] = mel
    del trainer, states
    gc.collect()
    torch.cuda.empty_cache()

    if recipe == "msstft":
        return out
    wavs = root / f"in_{recipe}"
    wavs.mkdir()
    for i in range(ZOO_FILES):
        shutil.copy(root / "wav" / f"{i:02d}.wav", wavs / f"{i:02d}.wav")
    argv = ["--config", str(root / "ckpts" / recipe / "exp_config.json"), "--checkpoint_path",
            str(root / "ckpts" / recipe / "checkpoint"), "--output_dir",
            str(root / f"out_{recipe}"), "--mode", "from_audio", "--audio_dir", str(wavs)]
    if recipe == "nsfhifigan":
        try:
            inference.main(argv)
            raised = ""
        except NotImplementedError as exc:
            raised = str(exc)
        check("zoo nsfhifigan copy synthesis raises", "F0" in raised, repr(raised[:120]))
        return out
    for k in kernels.values():
        k.reset()
    t0 = time.perf_counter()
    recs = inference.main(argv)
    torch.cuda.synchronize()
    synth_wall = time.perf_counter() - t0
    got = {name: k.launches for name, k in kernels.items() if k.launches}
    wav_ok = []
    for r in recs:
        wav, sr = load_wav(r["path"], sr=SR)
        src, _ = load_wav(wavs / Path(r["path"]).name, sr=SR)
        wav_ok.append(sr == SR and len(wav) == len(src) // HOP * HOP
                      and bool(np.isfinite(wav).all()) and float(np.abs(wav).max()) > 0)
    audio_s = sum(r["samples"] for r in recs) / SR
    file_s = sum(r["seconds"] for r in recs)
    check(f"zoo {recipe} copy synthesis", len(recs) == ZOO_FILES and all(wav_ok)
          and got == {"mel": ZOO_FILES},
          f"{len(recs)} wavs well-formed {wav_ok}; launches {got} (predicted mel "
          f"{ZOO_FILES}, one a file); {audio_s:.2f} audio s in {file_s:.3f} s of files "
          f"({synth_wall:.2f} s with the CLI's restore)")
    # audio s per s of the files (each: read, mel, generator, write), the
    # checkpoint's restore left out, as the vocoder phase counts it
    out.update(synth_audio_s_per_s=audio_s / file_s, synth_cli_wall_s=synth_wall,
               synth_file_s=[r["seconds"] for r in recs], synth_files=len(recs),
               synth_mel_launches=got["mel"])
    return out


def zoo_yin_check(seed: int) -> dict:
    """`ops/f0.yin_f0` at the base preprocess's front end (24 kHz, hop 120,
    1024-sample frames) on the card: a 2 s 220 Hz tone within 1 % at every
    frame away from the edges, and card against CPU on a batch of synthetic
    speech with the tone (f0 within 1e-3 relative or both unvoiced) on at
    least 99 % of the frames: a frame near the voicing threshold may flip."""
    from amphion_tpu_torch.ops.f0 import F0Config, yin_f0

    cfg = F0Config()
    rng = np.random.default_rng(seed + 53)
    t = np.arange(2 * SR) / SR
    tone = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    y = np.stack([tone] + [synth_audio(rng, 2.0)[: 2 * SR] for _ in range(7)])
    f0_card, v_card = yin_f0(torch.from_numpy(y).to(DEV), cfg)
    f0_cpu, v_cpu = yin_f0(torch.from_numpy(y), cfg)
    f0_card, v_card = f0_card.cpu(), v_card.cpu()
    inner = f0_card[0, 8:-8]
    tone_err = (inner / 220 - 1).abs().max().item()
    agree = ((v_card == v_cpu) & (~v_cpu | ((f0_card - f0_cpu).abs()
                                           <= 1e-3 * f0_cpu.abs()))).float().mean().item()
    check("zoo yin_f0 on the card", tone_err <= 0.01 and agree >= 0.99,
          f"220 Hz tone: max relative error {tone_err:.3g} over {inner.numel()} frames (tol "
          f"0.01); card vs CPU agree on {agree:.4f} of {f0_cpu.numel()} frames (tol 0.99); "
          f"{int(v_cpu.sum())} voiced on the CPU")
    return {"tone_max_rel_err": tone_err, "card_cpu_agree": agree}


def zoo_reference_phase(seed: int) -> None:
    """Card vs CPU (`gan_step_card_vs_cpu`) for two small float32 pairs at
    Flax-init weights: HiFi-GAN (32 channels) against MPD (periods 2, 3, a
    quarter width) + MS-SB-CQT (its three published scales), and
    NSF-HiFiGAN against MPD with its excitation draws made once on the CPU
    and given to both."""
    from amphion_tpu_torch.models.vocoders.gan_trainer import CombinedDiscriminator
    from amphion_tpu_torch.models.vocoders.hifigan import HiFiGANConfig, HiFiGANGenerator
    from amphion_tpu_torch.models.vocoders.nsf_hifigan import (
        NSFHiFiGANConfig, NSFHiFiGANGenerator)
    from amphion_tpu_torch.ops.f0 import F0Config, yin_f0
    from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram_ref

    mel_cfg = MelConfig(**ZOO_SMALL_MEL)
    gen = torch.Generator().manual_seed(seed + 59)
    rng = np.random.default_rng(seed + 59)
    audio = torch.from_numpy(np.stack([synth_audio(rng, 0.25)[:4096] for _ in range(4)]))
    mel = mel_spectrogram_ref(audio, mel_cfg).transpose(1, 2).contiguous()
    hifi = HiFiGANConfig(**ZOO_SMALL_HIFI)
    g = perturbed_flax_init(HiFiGANGenerator(hifi), gen)
    d = perturbed_flax_init(CombinedDiscriminator(("mpd", "mssbcqt"), (2, 3), channel_mult=0.25,
                                                  sample_rate=24000), gen)
    gan_step_card_vs_cpu("small f32 HiFi-GAN + MPD + MS-SB-CQT step", g, d, mel_cfg,
                         {"audio": audio, "mel": mel})
    f0, _ = yin_f0(audio, F0Config(sample_rate=24000, hop_size=16, frame_length=256))
    nsf = perturbed_flax_init(NSFHiFiGANGenerator(NSFHiFiGANConfig(base=hifi)), gen)
    d = perturbed_flax_init(CombinedDiscriminator(("mpd",), (2, 3), channel_mult=0.25), gen)
    f0 = f0[:, : mel.shape[1]]
    draws = nsf.draw(mel, f0, gen)
    gan_step_card_vs_cpu("small f32 NSF-HiFiGAN step (draws given)", nsf, d, mel_cfg,
                         {"audio": audio, "mel": mel, "f0": f0}, ("mel", "f0"), draws)


def zoo_phase(seed: int, kernels: dict, rows: list) -> dict:
    """The rest of the GAN vocoders, each at its egs/vocoder/gan recipe's
    width through `bins/vocoder/{train,inference}.py` on a synthetic corpus
    (`zoo_recipe`), one HiFi-GAN step against MPD + MS-STFT (no recipe sets
    it), YIN on the card, and two small steps card vs CPU; kernel 3's row of
    the timing line gets the path's launches and errors."""
    import shutil
    import tempfile
    from pathlib import Path

    zoo_reference_phase(seed)
    yin = zoo_yin_check(seed)
    root = Path(tempfile.mkdtemp(prefix="zoo_"))
    out = {}
    try:
        from amphion_tpu_torch.data.metadata import load_metadata, save_metadata

        gan_corpus(root, seed, n=ZOO_CLIPS)
        utts = load_metadata(root / "data" / "smoke" / "train.json")
        save_metadata(root / "data" / "one_batch" / "train.json", utts[:16])
        for recipe in ZOO_RECIPES + ("msstft",):
            out[recipe] = zoo_recipe(root, recipe, kernels, seed)
            shutil.rmtree(root / "ckpts" / recipe, ignore_errors=True)
            r = out[recipe]
            which = "its one step (cuDNN's plans included)" if recipe == "msstft" else \
                f"median step of {ZOO_STEPS}"
            log(f"zoo {recipe} perf ({nvidia_smi()}): {r['generator']}, {which} "
                f"{r['median_step_s']:.4f} s, {r['audio_s_per_s']:.2f} audio s of training a s, "
                f"peak {r['max_memory_allocated_gib']:.2f} GiB"
                + (f", copy synthesis {r['synth_audio_s_per_s']:.2f} audio s/s"
                   if "synth_audio_s_per_s" in r else "") + "; " + json.dumps(r))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row = next(r for r in rows if r["name"] == "mel_spectrogram")
    row["gan_zoo"] = {
        "launches": {k: v["mel_launches"] for k, v in out.items()},
        "copy_synthesis_launches": {k: v["synth_mel_launches"] for k, v in out.items()
                                    if "synth_mel_launches" in v},
        "launches_per_step": {k: v["mel_launches"] / v["steps"] for k, v in out.items()},
        "launches_per_file": {k: v["synth_mel_launches"] / v["synth_files"]
                              for k, v in out.items() if "synth_mel_launches" in v},
        "max_abs_err_vs_log_mel_ref": max(max(v["mel_check"]["real"]["vs_log_mel_ref"],
                                              v["mel_check"]["fake"]["vs_log_mel_ref"])
                                          for v in out.values())}
    return {"recipes": out, "yin": yin}


# -- MaskGCT: bins/serve.py's default backend (kernels 6, 3 and 1) -----------------

MG_CONFIG = "egs/tts/MaskGCT/exp_config.json"
MG_LAYERS = 16
MG_T2S_STEPS, MG_S2A_STEPS = 25, 16 + 11  # the samplers' defaults: 12 quantizers
# four requests of one (prompt, phone, target) bucket: prompts 3.6-4.0 s
# (0.5 s grid → 4.0 s → 400 codec frames, rung 448), 94-105 phones (rung
# 128), 470-500 target frames (rung 512); (prompt s, prompt text, target
# text, target frames, seed)
MG_REQUESTS = [
    (3.6, "the quick brown fox jumps over the lazy dog",
     "a bright morning light fell across the quiet harbor town", 470, 101),
    (3.75, "she sells sea shells by the sea shore",
     "every evening the old clock tower rang out over the hills", 480, 102),
    (3.9, "please call stella and ask her to bring these things",
     "the river ran cold and clear beneath the stone bridge", 490, 103),
    (4.0, "we walked along the beach until the sun went down",
     "music drifted from an open window on the second floor", 500, 104),
]
MG_SNAKE_PER_PASS = 4 * (2 * 3 + 1) + 1  # 29 in an encoder or a decoder pass
MG_LAUNCHES = {"flash_attn_fwd": MG_LAYERS * (MG_T2S_STEPS + MG_S2A_STEPS) * 2,  # 1 664
               "mel": len(MG_REQUESTS),  # 4
               "snake": MG_SNAKE_PER_PASS * (len(MG_REQUESTS) + 1)}  # 145
MG_GROUPS = [("flash_attn_fwd", ("flash_fwd",)), ("snake", ("snake",)), ("mel", ("mel_kernel",))]


class CallRecorder:
    """While installed, records calls of a wrapper that its callers look up by
    its module-level name at each call: ``keep(i, args)`` picks which (by
    call index) have their tensor arguments cloned. Thread-safe (the
    front end runs in the request threads, the batch in the batcher's)."""

    def __init__(self, mod, name: str, keep=lambda i, args: True):
        self.mod, self.name, self.wrapped = mod, name, getattr(mod, name)
        self.keep, self.calls, self.n = keep, [], 0
        self.lock = threading.Lock()
        setattr(mod, name, self)

    def __call__(self, *args, **kw):
        with self.lock:
            i, self.n = self.n, self.n + 1
        if self.keep(i, args):
            kept = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            with self.lock:
                self.calls.append((i, kept))
        return self.wrapped(*args, **kw)

    def remove(self) -> None:
        setattr(self.mod, self.name, self.wrapped)


def mg_flash_keep(i: int, args) -> bool:
    """The flash calls checked on the path: layers 0 and 15 of both passes at
    T2S steps 0, 12, 24 and S2A steps 0 and 15 (layer 0's first and last),
    16 (quantizer 1) and 26 (the last). Calls run 16 a pass, two passes a
    step, T2S first."""
    step, layer = divmod(i, 2 * MG_LAYERS)[0], i % MG_LAYERS
    return layer in (0, MG_LAYERS - 1) and step in (0, 12, 24, 25, 40, 41, 51)


def mg_write_checkpoints(root: str, seed: int) -> tuple[str, dict]:
    """A config over `egs/tts/MaskGCT/exp_config.json` under ``root``, its
    char symbol table, and port checkpoints at full width with random
    weights from ``seed``: T2S + S2A (the mel-proxy S2A: ``sem_proj``, no
    ``cond_emb``) under ``log_dir/maskgct/checkpoint``, the semantic codec
    and the acoustic codec (`mg_codec_unsaturated`) in their own."""
    import types

    from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec, CodecConfig
    from amphion_tpu_torch.models.codec.repcodec import RepCodec, RepCodecConfig
    from amphion_tpu_torch.models.tts.maskgct.maskgct import (
        MaskGCTS2A, MaskGCTT2S, S2AConfig, T2SConfig)
    from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
    from amphion_tpu_torch.text.g2p import G2PModule
    from amphion_tpu_torch.utils.config import load_config
    from amphion_tpu_torch.utils.convert import init_like_flax

    path = os.path.join(root, "maskgct.json")
    with open(path, "w") as f:
        json.dump({"base_config": os.path.abspath(MG_CONFIG), "dataset": ["smoke"],
                   "log_dir": os.path.join(root, "ckpts"),
                   "preprocess": {"processed_dir": os.path.join(root, "processed")}}, f)
    cfg = load_config(path)
    texts = [t for r in MG_REQUESTS for t in r[1:3]] + [MG_HTTP_TEXT]
    table = G2PModule("char").build_symbol_table(texts)
    table.to_file(os.path.join(root, "processed", "smoke", "symbols.dict"))
    m, p = cfg["model"], cfg["preprocess"]
    g = torch.Generator(DEV).manual_seed(seed)

    def save(model_state: dict, where: str) -> None:
        state = types.SimpleNamespace(state_dict=lambda: {"model": model_state})
        CheckpointManager(where).save(state, 1, 0, 0.0)

    with torch.device(DEV):
        t2s = init_like_flax(MaskGCTT2S(T2SConfig(
            **{k: m["t2s"][k] for k in ("hidden", "num_layers", "num_heads", "codebook_size")},
            phone_vocab=max(len(table) + 1, 64))), g)
        s2a = init_like_flax(MaskGCTS2A(S2AConfig(
            **{k: m["s2a"][k] for k in ("hidden", "num_layers", "num_heads", "codebook_size")},
            num_quantizers=m["codec"]["num_quantizers"],
            semantic_dim=m["semantic_codec"]["hidden"]), False, True), g)
        # the adaptive norms start at plain RMSNorm (to_weight 0): give them a
        # random conditioning path, as a trained model has
        for mod in (t2s, s2a):
            for name, prm in mod.named_parameters():
                if "to_weight.weight" in name:
                    prm.data.normal_(0.0, 0.02, generator=g)
        sem = init_like_flax(RepCodec(RepCodecConfig(
            feature_dim=p["n_mel"], **{k: v for k, v in m["semantic_codec"].items()
                                       if k in ("hidden", "codebook_size", "codebook_dim",
                                                "num_blocks")}), with_decode=True), g)
        codec = init_like_flax(AmphionCodec(CodecConfig(
            sample_rate=p["sample_rate"], **{k: tuple(v) if k == "strides" else v
                                             for k, v in m["codec"].items()})), g)
        mg_codec_unsaturated(codec, g)
    save({**{f"t2s.{k}": v for k, v in t2s.state_dict().items()},
          **{f"s2a.{k}": v for k, v in s2a.state_dict().items()}},
         os.path.join(root, "ckpts", "maskgct", "checkpoint"))
    save(sem.state_dict(), os.path.join(root, "semantic"))
    save(codec.state_dict(), os.path.join(root, "codec"))
    n_params = {k: sum(x.numel() for x in mod.parameters())
                for k, mod in (("t2s", t2s), ("s2a", s2a), ("semantic_codec", sem),
                               ("acoustic_codec", codec))}
    return path, n_params


MG_HTTP_TEXT = "good evening and welcome to the late news from the city"


@torch.no_grad()
def mg_codec_unsaturated(codec, g) -> None:
    """Snake α spread over [0.5, 1.5] and the residual units' output
    convolutions scaled to 0.3, so that the served batch's waveforms are not
    mostly the tanh's ±1: drawn as Flax draws it, the full-width decoder's
    last activation reaches about 50 and saturates 85 % of the tanh; so
    scaled, about 2.6. The values are chosen for that, not taken from a
    trained codec; `maskgct_reference_phase` holds the card at Flax's own
    draws."""
    for name, prm in codec.named_parameters():
        if name.endswith("alpha"):
            prm.uniform_(0.5, 1.5, generator=g)
        elif ".res_" in name and name.endswith("Conv_1.scale"):
            prm.fill_(0.3)


def mg_serve(svc, reqs, audio) -> tuple[list, float]:
    """The requests at once, one thread each → (waveforms, wall)."""
    out = [None] * len(reqs)

    def one(i):
        _, ptext, ttext, tlen, sd = reqs[i]
        out[i] = svc.synthesize(audio[i], ptext, ttext, target_len=tlen, seed=sd)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(reqs))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(w is None for w in out):
        raise SystemExit("maskgct: a request did not finish")
    return out, wall


class MGTokens:
    """Records the samplers' outputs in `serving/service` (rows in request
    order: the four target lengths differ)."""

    def __init__(self):
        from amphion_tpu_torch.serving import service as svc_mod

        self.mod, self.out = svc_mod, {"t2s": [], "s2a": []}
        self.real = {"t2s": svc_mod.t2s_sample_ragged, "s2a": svc_mod.s2a_sample_ragged}
        for key in self.real:
            setattr(svc_mod, f"{key}_sample_ragged", self._wrap(key))

    def _wrap(self, key):
        def run(*a, **kw):
            out = self.real[key](*a, **kw)
            order = torch.argsort(a[-3].cpu())
            self.out[key].append(out.cpu()[order])
            return out
        return run

    def remove(self):
        for key, fn in self.real.items():
            setattr(self.mod, f"{key}_sample_ragged", fn)


def mg_profile(svc, audio) -> dict:
    """One batch under torch.profiler (device activity): wall, busy share and
    device time by group (library GEMMs, #6, #1, #3, cuDNN's convolutions,
    the rest: elementwise, copies, sort and top-k)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = mg_serve(svc, MG_REQUESTS, audio)
        torch.cuda.synchronize()
    by_name, n = device_us_by_name(prof)
    groups = {g: 0.0 for g, _ in MG_GROUPS}
    groups.update(gemm=0.0, conv=0.0, other=0.0)
    for name, us in by_name.items():
        group = next((g for g, pats in MG_GROUPS if all(p in name for p in pats)), None)
        low = name.lower()
        if group is None and any(t in low for t in ("conv", "implicit", "winograd", "cudnn",
                                                     "fft", "dgrad", "wgrad")):
            group = "conv"
        if group is None:
            group = "gemm" if any(t in low for t in LIBRARY_GEMM) else "other"
        groups[group] += us
    busy = sum(groups.values()) / 1e6
    top = sorted(((us, k[:90]) for k, us in by_name.items()), reverse=True)
    return {"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_records": n, "by_group_s": {k: v / 1e6 for k, v in groups.items()},
            "top_kernels_ms": [[k, us / 1e3] for us, k in top[:10]]}


def maskgct_reference_phase(seed: int) -> None:
    """A small MaskGCT batch in float32 on the card against the CPU, at the
    weights Flax's init draws, the same draws injected in both (numpy Gumbel
    noise): T2S and S2A tokens equal. The codec decode of those codes is held
    to the CPU's float64 decode of them, the truth: at these weights the
    decoder's activations reach tens and float32 rounding alone moves the
    waveform by about 1e-3 on either device, so a card-vs-CPU float32 gap
    says nothing by itself. Two witnesses: the card's float64 decode (plain
    Snake; #1 takes float32 only) within 1e-9 of the truth, and the card's
    float32 decode (#1) no further from it than 4x the CPU's float32
    decode is."""
    import copy

    from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec, CodecConfig
    from amphion_tpu_torch.models.tts.maskgct import ragged_sampling as rs
    from amphion_tpu_torch.models.tts.maskgct.maskgct import (
        MaskGCTS2A, MaskGCTT2S, S2AConfig, T2SConfig)
    from amphion_tpu_torch.modules.activations import Snake
    from amphion_tpu_torch.utils.convert import init_like_flax

    g = torch.Generator().manual_seed(seed + 13)
    t2s = init_like_flax(MaskGCTT2S(T2SConfig(hidden=128, num_layers=2, num_heads=2,
                                              codebook_size=256, phone_vocab=64)), g).eval()
    s2a = init_like_flax(MaskGCTS2A(S2AConfig(hidden=128, num_layers=2, num_heads=2,
                                              codebook_size=64, num_quantizers=3,
                                              semantic_dim=32), False, True), g).eval()
    codec = init_like_flax(AmphionCodec(CodecConfig(num_quantizers=3, codebook_size=64)), g)
    codec64 = copy.deepcopy(codec).double()
    for mod in codec64.modules():
        if isinstance(mod, Snake):
            mod.use_pallas = False
    for mod in (t2s, s2a):
        for name, prm in mod.named_parameters():
            if "to_weight.weight" in name:
                prm.data.normal_(0.0, 0.05, generator=g)
    rng = np.random.default_rng(seed + 14)
    b, lp, lph, tm = 3, 40, 48, 64
    inp = dict(prompt=rng.integers(0, 256, (b, lp)), plen=[40, 27, 33],
               phone=rng.integers(1, 64, (b, lph)), phlen=[48, 30, 41], tlen=[64, 45, 57],
               pac=rng.integers(0, 64, (b, 3, lp)),
               sem=rng.standard_normal((b, lp + tm, 32)).astype(np.float32))
    t2s_draws = [rng.gumbel(size=(b, tm, 256) if i % 2 == 0 else (b, tm)).astype(np.float32)
                 for i in range(2 * 6)]
    s2a_draws = [rng.gumbel(size=(b, tm, 64) if i % 2 == 0 else (b, tm)).astype(np.float32)
                 for i in range(2 * (4 + 2))]
    outs = {}
    for dev in ("cuda", "cpu"):
        for mod in (t2s, s2a, codec, codec64):
            mod.to(dev)

        def L(k):
            return torch.as_tensor(np.asarray(inp[k])).long().to(dev)
        sem = rs.t2s_sample_ragged(t2s, L("prompt"), L("plen"), L("phone"), L("phlen"),
                                   L("tlen"), [None] * b, tm, n_steps=6,
                                   compute_dtype="float32", gumbel=iter(t2s_draws))
        codes = rs.s2a_sample_ragged(s2a, torch.as_tensor(inp["sem"]).to(dev), L("pac"),
                                     L("plen"), L("tlen"), [None] * b, tm, first_layer_steps=4,
                                     compute_dtype="float32", gumbel=iter(s2a_draws))
        with torch.no_grad():
            wav = codec.decode_codes(codes.transpose(0, 1), L("tlen"))
            wav64 = codec64.decode_codes(codes.transpose(0, 1), L("tlen"))
        outs[dev] = sem.cpu(), codes.cpu(), wav.double().cpu(), wav64.cpu()
    (s_g, c_g, w_g, w64_g), (s_c, c_c, w_c, truth) = outs["cuda"], outs["cpu"]

    def err(a, b):
        return (a - b).abs().max().item()
    e64, e_card, e_cpu = err(w64_g, truth), err(w_g, truth), err(w_c, truth)
    check("maskgct reference: a small f32 batch at Flax-init weights, card vs CPU with the "
          "same draws",
          torch.equal(s_g, s_c) and torch.equal(c_g, c_c) and e64 <= 1e-9
          and e_card <= 4 * e_cpu and bool(torch.isfinite(w_g).all())
          and truth.abs().max().item() > 1e-3,
          f"semantic tokens equal {torch.equal(s_g, s_c)} "
          f"({(s_g == s_c).float().mean().item():.4f}), acoustic codes equal "
          f"{torch.equal(c_g, c_c)} ({(c_g == c_c).float().mean().item():.4f}); waveform "
          f"against the CPU's float64 decode: card float64 max|err| {e64:.3g} (tol 1e-9), "
          f"card float32 {e_card:.3g}, CPU float32 {e_cpu:.3g} (card tol 4x CPU); card vs CPU "
          f"float32 {err(w_g, w_c):.3g}; {(truth.abs() > 0.999).double().mean().item():.3f} of "
          f"the samples saturate the tanh")


def maskgct_phase(seed: int, kernels: dict) -> dict:
    """MaskGCT as `bins/serve.py` serves it by default, at the width of
    `egs/tts/MaskGCT/exp_config.json` (T2S and S2A 1024 × 16 layers, bf16;
    codec 12 × 1024 RVQ, strides 2·4·5·6; semantic codec 8 192 codes; mel
    front end), random weights from ``seed`` written as port checkpoints:
    the pipeline built by `bins/tts/inference.build_maskgct_pipeline`, four
    concurrent requests through `MaskGCTService` (a warm-up batch, a counted
    and recorded batch, a profiled one), request 0 alone, kernels 6, 1 and 3
    on the inputs the path gave them, then `bins/serve.py`'s maskgct backend
    on 127.0.0.1 under `serving/loadgen.py`."""
    import logging
    import tempfile

    from amphion_tpu_torch.bins import serve as serve_cli
    from amphion_tpu_torch.bins.tts.inference import build_maskgct_pipeline
    from amphion_tpu_torch.ops import mel as mel_ops
    from amphion_tpu_torch.ops.kernels import flash_attention as flash_mod
    from amphion_tpu_torch.ops.kernels import snake as snake_mod
    from amphion_tpu_torch.ops.kernels.mel import log_mel_ref
    from amphion_tpu_torch.serving.service import MaskGCTService
    from amphion_tpu_torch.utils.config import load_config

    rng = np.random.default_rng(seed + 60)
    audio = [synth_audio(rng, r[0]) for r in MG_REQUESTS]
    out = {"card": nvidia_smi()}
    with tempfile.TemporaryDirectory(prefix="maskgct_") as root:
        t0 = time.perf_counter()
        path, out["parameters"] = mg_write_checkpoints(root, seed)
        out["checkpoints_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        # the CLI's own defaults (max_batch 8, max_wait_ms 50, len_step 64, bf16)
        args = serve_cli.parse_args([
            "--config", path, "--semantic_ckpt", os.path.join(root, "semantic"),
            "--codec_ckpt", os.path.join(root, "codec"), "--device", DEV, "--port", "0"])
        t0 = time.perf_counter()
        pipe = build_maskgct_pipeline(args, load_config(path), logging.getLogger("smoke"),
                                      device=DEV, compute_dtype="bfloat16")
        out["build_s"] = time.perf_counter() - t0
        check("maskgct: the pipeline as built from the checkpoints",
              not pipe.token_cond and pipe.semantic_rate == 200
              and pipe.t2s.mask_emb.dtype == torch.bfloat16
              and pipe.acoustic_codec.cfg.hop == 240
              and pipe.acoustic_codec.cfg.num_quantizers == 12,
              f"S2A conditioning: {'tokens' if pipe.token_cond else 'codec latents'} (its "
              f"checkpoint holds sem_proj, no cond_emb), semantic rate {pipe.semantic_rate} Hz, "
              f"T2S/S2A {pipe.t2s.mask_emb.dtype}, parameters {out['parameters']}")
        # a window long enough for the four front ends, closed by the fourth
        svc = MaskGCTService(pipe, max_batch=4, max_wait_ms=10000.0)
        solo = MaskGCTService(pipe, max_batch=4, max_wait_ms=1.0)
        try:
            warm, out["warmup_wall_s"] = mg_serve(svc, MG_REQUESTS, audio)
            toks = MGTokens()
            flash_rec = CallRecorder(flash_mod, "_flash_forward", mg_flash_keep)
            snake_rec = CallRecorder(snake_mod, "snake")
            mel_rec = CallRecorder(mel_ops, "log_mel")
            try:
                torch.cuda.synchronize()
                for k in kernels.values():
                    k.reset()
                wavs, wall = mg_serve(svc, MG_REQUESTS, audio)
                torch.cuda.synchronize()
                launches = {name: k.launches for name, k in kernels.items()}
                for rec in (flash_rec, snake_rec, mel_rec):
                    rec.remove()
                batch_toks = {k: v[-1] for k, v in toks.out.items()}
                mg_serve(solo, MG_REQUESTS[:1], audio[:1])
                alone_toks = {k: v[-1] for k, v in toks.out.items()}
            finally:
                for rec in (toks, flash_rec, snake_rec, mel_rec):
                    rec.remove()
            audio_s = sum(len(w) for w in wavs) / SR
            out.update(batch_wall_s=wall, audio_s=audio_s, audio_s_per_s=audio_s / wall,
                       launches=launches, stats=svc.stats())
            want = {k: MG_LAUNCHES.get(k, 0) for k in launches}
            check("maskgct batch: launches as worked out beforehand (#6 16 layers x (25 + 27) "
                  "steps x 2 passes, #3 one a request, #1 29 a codec pass x (4 encodes + 1 "
                  "batched decode)), no other kernel", launches == want,
                  f"{launches} (want {want})")
            lens = [len(w) for w in wavs]
            check("maskgct batch: four finite waveforms of target_len x 240 samples",
                  lens == [r[3] * 240 for r in MG_REQUESTS]
                  and all(np.isfinite(w).all() and np.abs(w).max() > 1e-3 for w in wavs)
                  and svc.stats()["max_batch"] == 4,
                  f"lengths {lens}, max|wav| {[float(np.abs(w).max()) for w in wavs]}, batch "
                  f"sizes up to {svc.stats()['max_batch']}")
            same = [bool(np.array_equal(a, b)) for a, b in zip(warm, wavs)]
            agree = {k: float((alone_toks[k][0] == batch_toks[k][0]).float().mean())
                     for k in batch_toks}
            out.update(rerun_bit_equal=same, alone_vs_batch_token_agreement=agree)
            log(f"maskgct: the batch again equals the warm-up batch bit for bit: {same}; "
                f"request 0 alone against request 0 in the batch (bf16 cuBLAS products, no "
                f"row-invariance promise: reported, not gated): semantic tokens agree "
                f"{agree['t2s']:.4f}, acoustic codes {agree['s2a']:.4f}")
            # kernel 6 on the calls recorded at its wrapper
            worst6, short = 0.0, 0
            for i, (q, k, v, mask, causal, lse) in flash_rec.calls:
                got = flash_mod._flash_forward(q, k, v, mask, causal, False)
                ref = flash_mod.attention_ref(q, k, v, mask, causal)
                ok, detail = close_bf16(got, ref)
                again = torch.equal(flash_mod._flash_forward(q, k, v, mask, causal, False), got)
                if not (ok and again):
                    check(f"maskgct #6 call {i} {tuple(q.shape)}", False,
                          f"{detail}; relaunch bit-equal {again}")
                worst6 = max(worst6, (got.float() - ref.float()).abs().max().item())
                short += int(mask is not None and bool((mask == 0).any()))
            check("maskgct #6 on the path's own inputs against attention_ref (bf16 tolerance)",
                  len(flash_rec.calls) == 28 and short > 0,
                  f"{len(flash_rec.calls)} recorded calls (layers 0 and 15 of both passes, "
                  f"7 steps), {short} with a key mask that cuts a row short, each within "
                  f"tolerance and bit-equal on relaunch; max|err| {worst6:.3g}")
            # kernel 1: every launch of the batch to the bit
            worst1, shapes = 0.0, {}
            for i, (x, alpha) in snake_rec.calls:
                got, ref = snake_mod.snake(x, alpha), snake_mod.snake_ref(x, alpha)
                if not torch.equal(got, ref):
                    err = (got - ref).abs().max().item()
                    check(f"maskgct #1 call {i} {tuple(x.shape)}", False,
                          f"max|err| {err:.3g} (want bit-equal)")
                shapes.setdefault(tuple(x.shape), [x, alpha, 0])[2] += 1
            check("maskgct #1: each of the batch's launches bit-equal to snake_ref",
                  len(snake_rec.calls) == MG_LAUNCHES["snake"],
                  f"{len(snake_rec.calls)} launches, {len(shapes)} shapes from "
                  f"{min(shapes)} to {max(shapes)}, float32, each the plain version's bits")
            worst3 = 0.0
            for i, (y, fb, n_fft, hop, win, clip) in mel_rec.calls:
                got = mel_ops.log_mel(y, fb, n_fft, hop, win, clip)
                worst3 = max(worst3, (got - log_mel_ref(y, fb, n_fft, hop, win, clip))
                             .abs().max().item())
            check("maskgct #3: the front end's calls against the plain version",
                  len(mel_rec.calls) == 4 and worst3 <= 1e-3,
                  f"{len(mel_rec.calls)} calls, max|err| {worst3:.3g} (tol 1e-3)")
            out["profile"] = mg_profile(svc, audio)
            log(f"maskgct profiled batch ({nvidia_smi()}): {json.dumps(out['profile'])}")
        finally:
            svc.shutdown()
            solo.shutdown()
        out["max_abs_err"] = {"flash_attn_fwd": worst6, "snake": 0.0, "mel": worst3}
        rows = mg_kernel_rows(flash_rec.calls, shapes, launches, worst6)
        del pipe, svc, solo, flash_rec, snake_rec, mel_rec
        gc.collect()
        torch.cuda.empty_cache()
        out["http"] = mg_http_phase(args, kernels, audio)
        out["cli"] = mg_cli_check(path, root, audio[0])
    log(f"maskgct ({out['card']}): " + json.dumps(
        {k: v for k, v in out.items() if k not in ("profile",)}))
    out["rows"] = rows
    return out


def mg_cli_check(path: str, root: str, audio: np.ndarray) -> dict:
    """`bins/tts/inference.py` in MaskGCT mode as a user runs it (the CLI's
    defaults: bf16 T2S and S2A, seed 0) on the phase's checkpoints: the wav
    holds target_len codec frames of 240 samples, target_len the
    proportional estimate the run's own pipeline gave the T2S."""
    from amphion_tpu_torch.bins.tts import inference as tts_cli
    from amphion_tpu_torch.data.audio_io import load_wav, save_wav
    from amphion_tpu_torch.pipelines import maskgct_pipeline as pipe_mod

    prompt = os.path.join(root, "prompt.wav")
    save_wav(prompt, audio, SR)
    lengths = []
    real = pipe_mod.t2s_sample_ragged

    def recording(model, prompt_tokens, *a, **kw):
        lengths.append((int(prompt_tokens.shape[1]), int(a[5])))  # a[5]: t_max
        return real(model, prompt_tokens, *a, **kw)
    pipe_mod.t2s_sample_ragged = recording
    out_wav = os.path.join(root, "maskgct_cli.wav")
    ptext, ttext = MG_REQUESTS[0][1:3]
    t0 = time.perf_counter()
    try:
        tts_cli.main(["--config", path, "--exp_name", "maskgct", "--semantic_ckpt",
                      os.path.join(root, "semantic"), "--codec_ckpt", os.path.join(root, "codec"),
                      "--prompt_audio", prompt, "--prompt_text", ptext, "--text", ttext,
                      "--output_path", out_wav, "--device", DEV])
    finally:
        pipe_mod.t2s_sample_ragged = real
    wall = time.perf_counter() - t0
    wav, sr = load_wav(out_wav)
    (lp, tl), = lengths
    n_prompt, n_target = len(ptext), len(ttext)
    want_tl = int(lp * (n_target / n_prompt)) + 1
    check("maskgct CLI (bins/tts/inference.py, model_type MaskGCT): a 24 kHz wav of target_len "
          "x 240 samples, target_len the proportional estimate",
          sr == SR and tl == want_tl and len(wav) == tl * 240 and np.abs(wav).max() > 1e-3,
          f"{len(wav)} samples at {sr} Hz; semantic prompt {lp} frames, target_len {tl} (want "
          f"{want_tl}: {n_target} / {n_prompt} phones), {wall:.1f} s")
    return {"wall_s": wall, "target_len": tl, "samples": len(wav)}

def mg_http_phase(args, kernels: dict, audio: list) -> dict:
    """`bins/serve.py --backend maskgct` as a user starts it (the backend factory the
    CLI calls, `serve` on 127.0.0.1 at a port the OS picks), answering six
    requests of a fixed Poisson trace from `serving/loadgen.py`; each
    response a 24 kHz mono PCM16 wav of ``int(target_sec · 200)`` codec
    frames of 240 samples."""
    import base64
    import io
    import urllib.request
    import wave

    from amphion_tpu_torch.bins import serve as serve_cli
    from amphion_tpu_torch.serving import loadgen

    t0 = time.perf_counter()
    backend = serve_cli.BUILDERS["maskgct"](args)
    build_s = time.perf_counter() - t0
    httpd = serve_cli.serve(backend.synth, backend.stats, "maskgct", port=0,
                            input_sr=backend.sample_rate)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    secs = [2.35, 2.4, 2.45, 2.5, 2.4, 2.45]
    replies = {}
    submit = loadgen.http_synthesize_submit(url, timeout_s=600)

    def make_request(i):
        r = MG_REQUESTS[i % len(MG_REQUESTS)]
        wav = serve_cli._encode_wav_bytes(audio[i % len(audio)], SR)
        return {"prompt_wav": base64.b64encode(wav).decode(), "prompt_text": r[1],
                "target_text": r[2] if i < 4 else MG_HTTP_TEXT, "target_sec": secs[i],
                "seed": 700 + i}

    def keep(payload):
        replies[payload["seed"]] = submit(payload)

    try:
        for k in kernels.values():
            k.reset()
        res = loadgen.run_trace(keep, make_request, loadgen.poisson_arrivals(2.0, 6, seed=3),
                                drain_timeout_s=600)
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items()}
        with urllib.request.urlopen(url + "/api/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
        backend.shutdown()
    lens = {}
    for sd, data in sorted(replies.items()):
        with wave.open(io.BytesIO(data)) as w:
            lens[sd] = (w.getframerate(), w.getnchannels(), w.getsampwidth(), w.getnframes())
    want = {700 + i: (SR, 1, 2, int(s * 200) * 240) for i, s in enumerate(secs)}
    out = {"build_s": build_s, "load": res.row(), "latency_ms": res.lat_ms, "stats": stats,
           "launches": launches}
    log(f"maskgct http (bins/serve.py, window batcher, {nvidia_smi()}): " + json.dumps(out))
    check("maskgct http: six requests answered with well-formed wavs",
          res.n_ok == 6 and res.n_err == 0 and lens == want,
          f"{res.n_ok} ok, {res.n_err} failed; (rate, channels, width, samples) {lens}, "
          f"want {want}")
    check("maskgct http: the path's kernels launched (#3 once a request)",
          launches["flash_attn_fwd"] > 0 and launches["snake"] > 0 and launches["mel"] == 6
          and stats["completed"] == 6, json.dumps(launches))
    return out


def mg_kernel_rows(flash_calls, snake_shapes: dict, launches: dict, flash_err: float) -> list:
    """Rows of kernels 6 and 1 at this path's shapes: #6 at the T2S
    conditional pass (the first recorded call: (4, 1088, 16, 64) bf16 with
    its ragged key mask) against attention_ref and SDPA; #1 at each of the
    codec's Snake shapes on its recorded input (the mean weighted by the
    batch's launches of each shape) against snake_ref (no library call
    computes Snake)."""
    from amphion_tpu_torch.ops.kernels import flash_attention as flash_mod
    from amphion_tpu_torch.ops.kernels import snake as snake_mod

    q, k, v, mask, causal, _ = flash_calls[0][1]
    b, L, h, d = q.shape
    valid = (mask > 0).sum(dim=1).float()
    bmask = (mask > 0)[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kernel = lambda: flash_mod.flash_attention(q, k, v, mask)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bmask)  # noqa: E731
    fl_ms, fl_lib = graph_ms(kernel), graph_ms(sdpa)
    fl_plain = graph_ms(lambda: flash_mod.attention_ref(q, k, v, mask), iters=5)
    fl_flops = 4.0 * h * d * L * float(valid.sum())
    fl_bytes = 4 * b * L * h * d * 2 + b * L * 4
    fl_bound, fl_by = _bound(fl_flops, fl_bytes)
    log(f"timing maskgct flash_attn_fwd ({nvidia_smi()}): ({b}, {L}, {h}, {d}) bf16, valid keys "
        f"{valid.long().tolist()}: kernel {fl_ms:.5f} ms ({fl_flops / fl_ms / 1e9:.1f} "
        f"TFLOP/s), plain {fl_plain:.5f} ms, SDPA {fl_lib:.5f} ms, bound {fl_bound:.5f} ms")
    rows = [_row("flash_attn_fwd_maskgct", "flash_attn_fwd.cu", 843, launches["flash_attn_fwd"],
                 flash_err, fl_ms, fl_plain, fl_bound, fl_by, fl_lib,
                 ms_is=f"one call at the T2S conditional pass ({b}, {L}, {h}, {d}) bf16 with "
                       f"the batch's ragged key mask (valid {valid.long().tolist()}), recorded "
                       "at the wrapper; CUDA-graph replays",
                 launches_are="one MaskGCT batch of four (T2S 25 steps, S2A 27, two passes a "
                              "step, 16 layers)")]
    per = []
    for shape, (x, alpha, n) in sorted(snake_shapes.items()):
        ms = graph_ms(lambda: snake_mod.snake(x, alpha))
        plain = graph_ms(lambda: snake_mod.snake_ref(x, alpha))
        numel = x.numel()
        bound, by = max(6.0 * numel / PEAK_F32, (8.0 * numel + 4 * shape[2]) / HBM) * 1e3, (
            "operations" if 6.0 * numel / PEAK_F32 >= (8.0 * numel + 4 * shape[2]) / HBM
            else "bytes")
        per.append({"shape": shape, "launches": n, "ms": ms, "plain_ms": plain,
                    "bound_ms": bound, "bound_by": by})
    tot = sum(p["launches"] for p in per)

    def mean(key):
        return sum(p[key] * p["launches"] for p in per) / tot
    log(f"timing maskgct snake ({nvidia_smi()}): " + json.dumps(per))
    rows.append(_row("snake_maskgct", "snake.cu", 78, launches["snake"], 0.0, mean("ms"),
                     mean("plain_ms"), mean("bound_ms"),
                     max(("bytes", "operations"),
                         key=lambda k: sum(p["bound_by"] == k for p in per)), None,
                     ms_is="mean per launch over one MaskGCT batch's 145 (4 codec encodes of 4 s "
                           "prompts, 1 batched decode of 4 x 512 frames), each shape timed on "
                           "its recorded input by CUDA-graph replays",
                     per_shape=per, via="pallas_kernels.py:89 snake_pallas, forward only"))
    return rows


# -- VALL-E: bins/serve.py --backend valle and bins/tts/inference.py ----------------

VALLE_CONFIG = "egs/tts/VALLE/exp_config.json"
VALLE_LAYERS, VALLE_HIDDEN, VALLE_FFN, VALLE_VOCAB = 12, 1024, 2816, 1025  # config/valle.json
VALLE_MAX_NEW = 192  # the AR's steps (the CLI's --max_new is 768; cut for the run's time)
# (prompt text, target text): 65, 83, 109 and 118 phones (char G2P), one phone bucket (128)
VALLE_TEXTS = [
    ("the quick brown fox jumps", "over the lazy dog by the old river bank"),
    ("she sells sea shells by the sea shore", "while the waves roll in under a pale grey sky"),
    ("please call stella and ask her to bring these things",
     "a bright morning light fell across the quiet harbor town"),
    ("we walked along the beach until the sun went down",
     "and music drifted from an open window on the second floor of the inn")]
VALLE_ENGINE_SECONDS = (3.0, 3.5, 4.0, 4.5)  # prompts of the engine run: buckets 320-512
VALLE_BATCH_SECONDS = (3.6, 3.7, 3.8, 4.0)  # the window batch: 400 frames, one bucket (448)
VALLE_SEEDS = (201, 202, 203, 204)
# worked out from the code beforehand: an AR pass (a prefill or a step) runs 12 layers x (2
# RMSNorms + 4 quantized projections) + the final norm + the head; a NAR call 7 stages x 12
# layers of kernel 6; a codec encode or decode 29 Snake activations
VALLE_AR_NORMS, VALLE_AR_PROJ = 2 * VALLE_LAYERS + 1, 4 * VALLE_LAYERS  # 25, 48 a pass
VALLE_NAR_FLASH = 7 * VALLE_LAYERS  # 84 a NAR call
VALLE_GROUPS = [("flash_attn_fwd", ("flash_fwd",)), ("snake", ("snake",)),
                ("rms_norm", ("rms_norm_kernel",)), ("int8_gemv", ("gemv_kernel", "::Int8,")),
                ("bf16_gemv", ("gemv_kernel", "::Bf16,"))]


def valle_write_checkpoints(root: str, seed: int) -> str:
    """A config over `egs/tts/VALLE/exp_config.json` under ``root`` (full
    width: 1024 x 12 layers, 16 heads, FFN 2816, 8 x 1024 codes), its char
    symbol table, and port checkpoints from random weights of ``seed``:
    VALL-E under ``log_dir/valle/checkpoint`` (the adaptive norms given a
    random conditioning path, as a trained NAR has) and the Amphion codec
    (`mg_codec_unsaturated`) under ``root/codec``."""
    import types

    from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec
    from amphion_tpu_torch.models.tts.valle.valle import VALLE, VALLEConfig
    from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
    from amphion_tpu_torch.bins.tts.inference import _codec_config
    from amphion_tpu_torch.text.g2p import G2PModule
    from amphion_tpu_torch.utils.config import load_config
    from amphion_tpu_torch.utils.convert import init_like_flax

    path = os.path.join(root, "valle.json")
    with open(path, "w") as f:
        json.dump({"base_config": os.path.abspath(VALLE_CONFIG), "dataset": ["smoke"],
                   "log_dir": os.path.join(root, "ckpts"),
                   "preprocess": {"processed_dir": os.path.join(root, "processed")}}, f)
    cfg = load_config(path)
    table = G2PModule("char").build_symbol_table([t for pair in VALLE_TEXTS for t in pair])
    table.to_file(os.path.join(root, "processed", "smoke", "symbols.dict"))
    m = cfg["model"]["valle"]
    g = torch.Generator(DEV).manual_seed(seed)
    with torch.device(DEV):
        model = init_like_flax(VALLE(VALLEConfig(
            num_phones=max(len(table) + 1, 64),
            **{k: m[k] for k in ("audio_vocab", "num_quantizers", "hidden", "num_layers",
                                 "num_heads", "max_position")})), g)
        for name, prm in model.named_parameters():
            if "to_weight.weight" in name:
                prm.data.normal_(0.0, 0.02, generator=g)
        codec = init_like_flax(AmphionCodec(_codec_config(cfg)), g)
        mg_codec_unsaturated(codec, g)
    for module, where in ((model, os.path.join(root, "ckpts", "valle", "checkpoint")),
                          (codec, os.path.join(root, "codec"))):
        state = types.SimpleNamespace(state_dict=lambda mod=module: {"model": mod.state_dict()})
        CheckpointManager(where).save(state, 1, 0, 0.0)
    return path


class ValleProjRecorder(ProjRecorder):
    """`ProjRecorder` on the quantized projections of VALL-E's AR, layers 0
    and 11 (K = 1024 for qkv, o and gateup, 2816 for down)."""

    def __init__(self, model):
        self.seen, self.hooks = {}, []
        for i in (0, VALLE_LAYERS - 1):
            layer = getattr(model.ar, f"layer_{i}")
            for label, mod in (("qkv", layer.attn.qkv_proj), ("o", layer.attn.o_proj),
                               ("gateup", layer.mlp.gateup_proj), ("down", layer.mlp.down_proj)):
                self.hooks.append(mod.register_forward_pre_hook(
                    self._hook(f"ar layer_{i} {label}")))


def valle_profile(fn) -> dict:
    """``fn()`` under torch.profiler (device activity): wall, busy share and
    device time by group (the port's kernels, library GEMMs, the rest)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, n = device_us_by_name(prof)
    groups = dict.fromkeys([g for g, _ in VALLE_GROUPS] + ["gemm", "conv", "other"], 0.0)
    for name, us in by_name.items():
        grp = next((g for g, pats in VALLE_GROUPS if all(p in name for p in pats)), None)
        low = name.lower()
        if grp is None and any(t in low for t in ("conv", "implicit", "winograd", "cudnn")):
            grp = "conv"
        if grp is None:
            grp = "gemm" if any(t in low for t in LIBRARY_GEMM) else "other"
        groups[grp] += us / 1e6
    busy = sum(groups.values())
    return {"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_records": n, "by_group_s": groups}


def valle_serve(svc, audio) -> tuple[list, float]:
    """Requests 0, 1, ... (one a prompt in ``audio``) at once, one thread
    each → (waveforms, wall)."""
    out = [None] * len(audio)

    def one(i):
        out[i] = svc.synthesize(audio[i], *VALLE_TEXTS[i], seed=VALLE_SEEDS[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(out))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if any(w is None for w in out):
        raise SystemExit("valle: a request did not finish")
    return out, time.perf_counter() - t0


def valle_engine_phase(model, tok, g2p, symbols, kernels: dict, max_new: int) -> dict:
    """(a) The int8 continuous engine (slots 4, chunk 64, the CLI's buckets):
    the four requests (prompts 3.0-4.5 s, 65-118 phones) admitted a chunk
    apart through the graph engine and an eager engine; each request's
    codebook-0 tokens equal its solo ragged decode at the engine's capacity.
    Launch counts against those worked out from the code; the projections'
    and the head's inputs recorded on the eager engine for (d)."""
    from amphion_tpu_torch.models.tts.valle import valle as valle_mod
    from amphion_tpu_torch.serving.continuous import ContinuousValleBatcher
    from amphion_tpu_torch.serving.continuous_service import ValleContinuousService

    rng = np.random.default_rng(301)
    audio = [synth_audio(rng, s) for s in VALLE_ENGINE_SECONDS]
    t0 = time.perf_counter()
    svc = ValleContinuousService(model, tok, g2p, symbols, slots=ENGINE_SLOTS,
                                 chunk=ENGINE_CHUNK, len_step=ENGINE_STEP, max_phone_len=512,
                                 max_prompt_len=512, max_new=max_new, compute_dtype="int8")
    build_s = time.perf_counter() - t0
    svc.driver.shutdown()  # the engine is driven chunk by chunk from here
    eng = svc.driver.engine
    reqs = [svc._prepare_request(a, *VALLE_TEXTS[i], VALLE_SEEDS[i]) for i, a in enumerate(audio)]
    reqs = [(r.phone_ids.cpu(), r.prompt_codes[0].cpu(), r.seed) for r in reqs]
    eager = ContinuousValleBatcher(svc.model, slots=ENGINE_SLOTS, chunk=ENGINE_CHUNK,
                                   phone_buckets=eng.buckets, prompt_buckets=eng.out_buckets,
                                   max_new=max_new, compute_dtype="int8", graphs=False)

    def staggered(e):
        rids, t0 = [], time.perf_counter()
        for ph, pr, seed in reqs:
            rids.append(e.submit(ph, pr, seed))
            e.step_chunk()
        done = e.run()
        torch.cuda.synchronize()
        return [done[r] for r in rids], time.perf_counter() - t0

    torch.cuda.synchronize()
    for k in kernels.values():
        k.reset()
    chunks0 = eng.chunks
    toks_g, wall_g = staggered(eng)
    launches = {name: k.launches for name, k in kernels.items()}
    steps = (eng.chunks - chunks0) * ENGINE_CHUNK
    rec = ValleProjRecorder(svc.model)
    head = CallRecorder(valle_mod, "bf16_linear", lambda i, args: i % 97 == 0)
    try:
        chunks0 = eager.chunks
        toks_e, wall_e = staggered(eager)
        steps_e = (eager.chunks - chunks0) * ENGINE_CHUNK
    finally:
        rec.remove()
        head.remove()
    t0 = time.perf_counter()
    solo = [svc.solo_tokens(ph, pr, seed) for ph, pr, seed in reqs]
    solo_s = (time.perf_counter() - t0) / len(reqs)
    lens = [len(t) for t in toks_g]
    same_e = [torch.equal(a, b) for a, b in zip(toks_g, toks_e)]
    same_s = [torch.equal(a, b) for a, b in zip(toks_g, solo)]
    check("valle engine int8: each staggered request's codebook-0 tokens equal its solo "
          "ragged decode at the engine's capacity, and the eager engine's",
          all(same_s) and all(same_e) and min(lens) > 0,
          f"solo {same_s}, eager {same_e}, lengths {lens} of {max_new}, capacity {eng.capacity}")
    passes = steps + len(reqs)  # every step and one prefill a request
    want = {name: 0 for name in launches}
    want.update(int8_matmul=VALLE_AR_PROJ * passes, rms_norm=VALLE_AR_NORMS * passes,
                bf16_gemv=passes)
    check("valle engine int8: launches as worked out beforehand (48 #4, 25 RMSNorms and 1 "
          "head GEMV an AR pass: 4 prefills + the steps, graph replays counted)",
          launches == want, f"{launches} (want {want}, {steps} steps)")

    def profiled_chunk():
        for ph, pr, seed in reqs:
            eng.submit(ph, pr, seed, max_new=3 * ENGINE_CHUNK)
        eng.step_chunk()  # admissions and a first chunk
        out = valle_profile(eng.step_chunk)
        out["rows"] = eng.last_rung
        out["ms_per_step"] = out["wall_s"] / ENGINE_CHUNK * 1e3
        eng.run()
        return out

    perf = {"capacity": eng.capacity, "capture_s": eng.capture_s, "service_build_s": build_s,
            "decode_steps": steps, "graph_wall_s": wall_g, "graph_steps_per_s": steps / wall_g,
            "tokens_per_s": sum(lens) / wall_g, "eager_steps_per_s": steps_e / wall_e,
            "solo_decode_s": solo_s, "launches": launches, "profiled_chunk": profiled_chunk()}
    log(f"valle engine int8 ({nvidia_smi()}): " + json.dumps(perf))
    return {"svc": svc, "perf": perf, "rec": rec, "head_calls": head.calls,
            "reqs": reqs, "launches": launches}


def valle_window_phase(model, tok, g2p, symbols, kernels: dict, max_new: int) -> dict:
    """(b) The window `VALLEService` in bf16 (the CLI's dtype), one batch of
    four in one bucket: a warm-up batch, then a counted batch with kernel 6's
    and kernel 1's calls recorded at their wrappers, request 0 alone
    (tokens agreeing with request 0 in the batch: reported), a profiled
    rerun. Casts ``model`` to bf16 in place."""
    from amphion_tpu_torch.ops.kernels import flash_attention as flash_mod
    from amphion_tpu_torch.ops.kernels import snake as snake_mod
    from amphion_tpu_torch.serving import service as service_mod
    from amphion_tpu_torch.serving.service import VALLEService

    rng = np.random.default_rng(302)
    audio = [synth_audio(rng, s) for s in VALLE_BATCH_SECONDS]
    kw = dict(len_step=ENGINE_STEP, max_phone_len=512, max_prompt_len=512, max_new=max_new,
              compute_dtype="bfloat16")
    svc = VALLEService(model, tok, g2p, symbols, max_batch=4, max_wait_ms=10000.0, **kw)
    solo = VALLEService(model, tok, g2p, symbols, max_batch=4, max_wait_ms=1.0, **kw)
    codes = []
    real = service_mod.valle_generate_ragged

    def recording(*a, **kw):
        out = real(*a, **kw)
        codes.append((a[2].cpu(), out[0].cpu(), out[1].cpu()))
        return out
    out = {"card": nvidia_smi()}
    service_mod.valle_generate_ragged = recording
    try:
        warm, out["warmup_wall_s"] = valle_serve(svc, audio)
        flash_rec = CallRecorder(flash_mod, "_flash_forward",
                                 lambda i, args: i % VALLE_LAYERS in (0, VALLE_LAYERS - 1))
        snake_rec = CallRecorder(snake_mod, "snake")
        try:
            torch.cuda.synchronize()
            for k in kernels.values():
                k.reset()
            wavs, wall = valle_serve(svc, audio)
            torch.cuda.synchronize()
            launches = {name: k.launches for name, k in kernels.items()}
        finally:
            flash_rec.remove()
            snake_rec.remove()
        phone_len, batch_codes, gen_len = codes[-1]
        valle_serve(solo, audio[:1])
        alone_codes, alone_len = codes[-1][1], codes[-1][2]
        out["profile"] = valle_profile(lambda: valle_serve(svc, audio))
    finally:
        service_mod.valle_generate_ragged = real
        svc.shutdown()
        solo.shutdown()
    want = {name: 0 for name in launches}
    want.update(rms_norm=VALLE_AR_NORMS * (1 + max_new), flash_attn_fwd=VALLE_NAR_FLASH,
                snake=MG_SNAKE_PER_PASS * (len(audio) + 1))
    check("valle window bf16 batch: launches as worked out beforehand (25 RMSNorms an AR "
          "pass x (1 prefill + the steps), #6 84 for the batch's NAR, #1 29 a codec pass x "
          "(4 encodes + 1 batched decode)), no other kernel", launches == want,
          f"{launches} (want {want})")
    lens = [len(w) for w in wavs]
    n_gen = gen_len.tolist()
    check("valle window bf16 batch: four finite waveforms of max(gen_len, 1) x 240 samples",
          lens == [max(n, 1) * 240 for n in n_gen]
          and all(np.isfinite(w).all() and np.abs(w).max() > 1e-3 for w in wavs),
          f"lengths {lens}, gen_len {n_gen}, max|wav| {[float(np.abs(w).max()) for w in wavs]}")
    row0 = int(torch.nonzero(phone_len == len(VALLE_TEXTS[0][0]) + 1
                             + len(VALLE_TEXTS[0][1]))[0])
    agree = int((alone_codes[0, 0] == batch_codes[row0, 0]).sum())
    audio_s = sum(lens) / SR
    out.update(batch_wall_s=wall, audio_s=audio_s, audio_s_per_s=audio_s / wall,
               launches=launches, gen_len=n_gen,
               rerun_bit_equal=[bool(np.array_equal(a, b)) for a, b in zip(warm, wavs)],
               request0_alone_agreeing_tokens=agree, request0_alone_gen_len=int(alone_len[0]))
    log(f"valle window bf16 ({out['card']}): " + json.dumps(out))
    # kernel 6 on the NAR's recorded calls, kernel 1 on every launch of the batch
    worst6, short = 0.0, 0
    for i, (q, k, v, mask, causal, lse) in flash_rec.calls:
        got = flash_mod._flash_forward(q, k, v, mask, causal, False)
        ref = flash_mod.attention_ref(q, k, v, mask, causal)
        ok, detail = close_bf16(got, ref)
        again = torch.equal(flash_mod._flash_forward(q, k, v, mask, causal, False), got)
        if not (ok and again):
            check(f"valle #6 call {i} {tuple(q.shape)}", False, f"{detail}; relaunch {again}")
        worst6 = max(worst6, (got.float() - ref.float()).abs().max().item())
        short += int(mask is not None and bool((mask == 0).any()))
    check("valle #6 on the NAR's own inputs against attention_ref (bf16 tolerance), bit-equal "
          "on relaunch", len(flash_rec.calls) == 14 and short == 14,
          f"{len(flash_rec.calls)} recorded calls (layers 0 and 11 of the 7 stages) of shape "
          f"{tuple(flash_rec.calls[0][1][0].shape)}, {short} with a key mask that cuts rows "
          f"short; max|err| {worst6:.3g}")
    shapes = {}
    for i, (x, alpha) in snake_rec.calls:
        if not torch.equal(snake_mod.snake(x, alpha), snake_mod.snake_ref(x, alpha)):
            check(f"valle #1 call {i} {tuple(x.shape)}", False, "not bit-equal to snake_ref")
        shapes.setdefault(tuple(x.shape), [x, alpha, 0])[2] += 1
    check("valle #1: each of the batch's launches bit-equal to snake_ref",
          len(snake_rec.calls) == want["snake"],
          f"{len(snake_rec.calls)} launches, {len(shapes)} shapes from {min(shapes)} to "
          f"{max(shapes)}, float32")
    out.update(flash_calls=flash_rec.calls, snake_shapes=shapes, flash_err=worst6)
    return out


def valle_quant_phase(rec, head_calls: list, model, reqs, kernels: dict) -> dict:
    """(d) Kernels 4 and 5 on the int8 engine's recorded projection inputs
    (K = 1024 and 2816; decode rows 1-4 and the prefills' rows), #5 with
    the int4 projections of the same weights (`prepare_for_decode`), and the
    head GEMV on its recorded inputs (N = 1025); then a 64-step int4 solo
    decode of request 0, its launches counted."""
    from amphion_tpu_torch.models.tts.valle.valle import ar_generate_ragged, prepare_for_decode
    from amphion_tpu_torch.ops.kernels.bf16_gemv import bf16_linear, bf16_linear_ref

    err8 = path_quant_check("valle int8", rec, int4=False)
    m4 = prepare_for_decode(model, "int4")
    import types

    rec4 = types.SimpleNamespace(seen={})
    for (name, m, pro), (_, x, rms) in rec.seen.items():
        _, layer, label = name.split()
        blk = getattr(m4.ar, layer)
        mod = {"qkv": blk.attn.qkv_proj, "o": blk.attn.o_proj, "gateup": blk.mlp.gateup_proj,
               "down": blk.mlp.down_proj}[label]
        rec4.seen[(name, m, pro)] = (mod, x, rms)
    err4 = path_quant_check("valle int4", rec4, int4=True)
    ks = sorted({x.shape[1] for _, x, _ in rec.seen.values()})
    ms = sorted({m for (_, m, _) in rec.seen})
    check("valle #4/#5 recorded at K = 1024 and 2816, decode rows and prefill rows",
          ks == [VALLE_HIDDEN, VALLE_FFN] and min(ms) == 1 and max(ms) > 8,
          f"K {ks}, rows {ms}")
    worst, shapes = 0.0, set()
    for i, (x, w) in head_calls:
        out, ref = bf16_linear(x, w), bf16_linear_ref(x, w)
        err = (out.float() - ref.float()).abs().max().item()
        ok = err <= 2e-2 * ref.float().abs().max().item() and torch.equal(bf16_linear(x, w), out)
        rows = all(torch.equal(bf16_linear(x[r:r + 1], w)[0], out[r]) for r in range(x.shape[0]))
        if not (ok and rows):
            check(f"valle head GEMV call {i} {tuple(x.shape)}", False,
                  f"max|err| {err:.3g}, rows alone bit-equal {rows}")
        worst, shapes = max(worst, err), shapes | {tuple(x.shape)}
    check("valle bf16_gemv (the 1025-wide head) on its recorded inputs: within 2e-2 of the "
          "plain version, relaunch and each row alone bit-equal",
          len(head_calls) > 0 and all(w.shape[0] == VALLE_VOCAB for _, (_, w) in head_calls),
          f"{len(head_calls)} calls, shapes {sorted(shapes)}, N {VALLE_VOCAB}, max|err| {worst:.3g}")
    ph, pr, seed = reqs[0]
    torch.cuda.synchronize()
    for k in kernels.values():
        k.reset()
    steps = 64
    ar_generate_ragged(m4, ph[None], torch.tensor([len(ph)]), pr[None], torch.tensor([len(pr)]),
                       [torch.Generator(DEV).manual_seed(seed)], max_new=steps,
                       compute_dtype="int4")
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    want = {name: 0 for name in launches}
    want.update(int4_matmul=VALLE_AR_PROJ * (1 + steps), rms_norm=VALLE_AR_NORMS * (1 + steps),
                bf16_gemv=1 + steps)
    check("valle int4 solo decode (64 steps): launches as worked out beforehand",
          launches == want, f"{launches} (want {want})")
    return {"int8_err": err8, "int4_err": err4, "head_err": worst, "m4": m4,
            "int4_launches": launches}


def valle_reference_phase(seed: int) -> None:
    """(e) A small float32 VALL-E (width 128, 2 layers, 64 codes, 3
    codebooks) and codec, at weights Flax's init draws, greedy on the card
    and on the CPU: a ragged batch of three, AR and NAR codes equal, and the
    codec decode of those codes against the CPU's float64 decode, the truth
    (`maskgct_reference_phase` says why): the card's float64 decode within
    1e-9 of it, its float32 decode (#1) no further from it than 4x the
    CPU's float32 decode."""
    import copy

    from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec, CodecConfig
    from amphion_tpu_torch.models.tts.valle.valle import VALLE, VALLEConfig, valle_generate_ragged
    from amphion_tpu_torch.modules.activations import Snake
    from amphion_tpu_torch.utils.convert import init_like_flax

    g = torch.Generator().manual_seed(seed + 17)
    model = init_like_flax(VALLE(VALLEConfig(num_phones=64, audio_vocab=64, num_quantizers=3,
                                             hidden=128, num_layers=2, num_heads=2)), g).eval()
    for name, prm in model.named_parameters():
        if "to_weight.weight" in name:
            prm.data.normal_(0.0, 0.05, generator=g)
    codec = init_like_flax(AmphionCodec(CodecConfig(num_quantizers=3, codebook_size=64)), g)
    codec64 = copy.deepcopy(codec).double()
    for mod in codec64.modules():
        if isinstance(mod, Snake):
            mod.use_pallas = False
    rng = np.random.default_rng(seed + 18)
    phones, plen = rng.integers(1, 64, (3, 40)), [40, 23, 31]
    prompt, clen = rng.integers(0, 64, (3, 3, 30)), [30, 17, 24]
    outs = {}
    for dev in (DEV, "cpu"):
        for mod in (model, codec, codec64):
            mod.to(dev)

        def L(a):
            return torch.as_tensor(np.asarray(a)).long().to(dev)
        codes, n = valle_generate_ragged(model, L(phones), L(plen), L(prompt), L(clen),
                                         max_new=48, temperature=0.0, compute_dtype="float32")
        with torch.no_grad():
            lens = torch.clamp(n, min=1)
            wav = codec.decode_codes(codes.transpose(0, 1), lens)
            wav64 = codec64.decode_codes(codes.transpose(0, 1), lens)
        outs[dev] = codes.cpu(), n.cpu(), wav.double().cpu(), wav64.cpu()
    (c_g, n_g, w_g, w64_g), (c_c, n_c, w_c, truth) = outs[DEV], outs["cpu"]

    def err(a, b):
        return (a - b).abs().max().item()
    e64, e_card, e_cpu = err(w64_g, truth), err(w_g, truth), err(w_c, truth)
    check("valle reference: a small f32 batch at Flax-init weights, greedy, card vs CPU",
          torch.equal(c_g, c_c) and torch.equal(n_g, n_c) and e64 <= 1e-9
          and e_card <= 4 * e_cpu and bool(torch.isfinite(w_g).all())
          and truth.abs().max().item() > 1e-3,
          f"codes equal {torch.equal(c_g, c_c)} ({(c_g == c_c).float().mean().item():.4f}), "
          f"gen_len {n_g.tolist()} / {n_c.tolist()}; waveform against the CPU's float64 decode: "
          f"card float64 max|err| {e64:.3g} (tol 1e-9), card float32 {e_card:.3g}, CPU float32 "
          f"{e_cpu:.3g} (card tol 4x CPU); card vs CPU float32 {err(w_g, w_c):.3g}")


def valle_http_phase(args, kernels: dict) -> dict:
    """(c) `bins/serve.py --backend valle` as a user starts it, at the CLI's
    defaults (continuous batcher, bf16; ``--max_new`` cut), on 127.0.0.1:
    six requests of a fixed Poisson trace from `serving/loadgen.py`; each a
    24 kHz mono PCM16 wav of whole codec frames; the path's launches."""
    import base64
    import io
    import urllib.request
    import wave

    from amphion_tpu_torch.bins import serve as serve_cli
    from amphion_tpu_torch.serving import loadgen

    rng = np.random.default_rng(303)
    audio = [synth_audio(rng, s) for s in (3.2, 3.9, 4.4, 3.6, 4.1, 3.3)]
    t0 = time.perf_counter()
    backend = serve_cli.BUILDERS["valle"](args)
    build_s = time.perf_counter() - t0
    httpd = serve_cli.serve(backend.synth, backend.stats, "valle", port=0,
                            input_sr=backend.sample_rate)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    replies = {}
    submit = loadgen.http_synthesize_submit(url, timeout_s=600)

    def make_request(i):
        ptext, ttext = VALLE_TEXTS[i % len(VALLE_TEXTS)]
        wav = serve_cli._encode_wav_bytes(audio[i], SR)
        return {"prompt_wav": base64.b64encode(wav).decode(), "prompt_text": ptext,
                "target_text": ttext, "seed": 800 + i}

    def keep(payload):
        replies[payload["seed"]] = submit(payload)

    try:
        torch.cuda.synchronize()
        for k in kernels.values():
            k.reset()
        res = loadgen.run_trace(keep, make_request, loadgen.poisson_arrivals(2.0, 6, seed=5),
                                drain_timeout_s=600)
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items()}
        with urllib.request.urlopen(url + "/api/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
        backend.shutdown()
    frames = {}
    for sd, data in sorted(replies.items()):
        with wave.open(io.BytesIO(data)) as w:
            ok = (w.getframerate(), w.getnchannels(), w.getsampwidth()) == (SR, 1, 2)
            frames[sd] = w.getnframes() // 240 if ok and w.getnframes() % 240 == 0 else None
    out = {"build_s": build_s, "load": res.row(), "latency_ms": res.lat_ms, "stats": stats,
           "launches": launches, "frames": frames}
    log(f"valle http (bins/serve.py, continuous batcher, bf16, {nvidia_smi()}): "
        + json.dumps(out))
    check("valle http: six requests answered with well-formed wavs of whole codec frames",
          res.n_ok == 6 and res.n_err == 0 and len(frames) == 6
          and all(f is not None and 0 < f <= args.max_new for f in frames.values()),
          f"{res.n_ok} ok, {res.n_err} failed; frames {frames}")
    passes = stats["chunks"] * ENGINE_CHUNK + stats["admitted"]
    want = {name: 0 for name in launches}
    want.update(rms_norm=VALLE_AR_NORMS * passes, flash_attn_fwd=VALLE_NAR_FLASH * 6,
                snake=2 * MG_SNAKE_PER_PASS * 6)
    check("valle http: launches as worked out beforehand (25 RMSNorms an AR pass over the "
          "engine's chunks and admissions, #6 84 and #1 58 a request)",
          launches == want and stats["admitted"] == 6 and stats["solo_served"] == 0,
          f"{launches} (want {want}; {stats['chunks']} chunks, {stats['admitted']} admitted)")
    return out


def valle_kernel_rows(win: dict, quant: dict, eng: dict, model) -> list:
    """Rows at VALL-E's shapes: #6 at the NAR's call ((4, 1024, 16, 64) bf16
    with the batch's key mask), #1 over the batch's Snake shapes, #4 and #5
    at one decode step's 48 projections (M = 4, the int8 engine's weights
    and their int4 quantization; K = 1024 and 2816, each projection type
    apart), and the head GEMV at N = 1025."""
    from amphion_tpu_torch.ops.kernels import flash_attention as flash_mod
    from amphion_tpu_torch.ops.kernels import snake as snake_mod
    from amphion_tpu_torch.ops.kernels.bf16_gemv import bf16_linear, bf16_linear_ref
    from amphion_tpu_torch.ops.kernels.int4_matmul import int4_matmul, int4_matmul_ref
    from amphion_tpu_torch.ops.kernels.int8_matmul import int8_matmul, int8_matmul_ref

    card = nvidia_smi()
    q, k, v, mask, causal, _ = win["flash_calls"][0][1]
    b, L, h, d = q.shape
    valid = (mask > 0).sum(dim=1).float()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    bmask = (mask > 0)[:, None, None, :]
    fl_ms = graph_ms(lambda: flash_mod.flash_attention(q, k, v, mask))
    fl_lib = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bmask))
    fl_plain = graph_ms(lambda: flash_mod.attention_ref(q, k, v, mask), iters=5)
    fl_bound, fl_by = _bound(4.0 * h * d * L * float(valid.sum()), 4 * b * L * h * d * 2 + b * L * 4)
    log(f"timing valle flash_attn_fwd ({card}): ({b}, {L}, {h}, {d}) bf16, valid keys "
        f"{valid.long().tolist()}: kernel {fl_ms} ms, plain {fl_plain} ms, SDPA {fl_lib} ms, "
        f"bound {fl_bound} ms ({fl_by})")
    rows = [_row("flash_attn_fwd_valle", "flash_attn_fwd.cu", 843,
                 win["launches"]["flash_attn_fwd"], win["flash_err"], fl_ms, fl_plain, fl_bound,
                 fl_by, fl_lib, ms_is=f"one NAR call ({b}, {L}, {h}, {d}) bf16 with the batch's "
                 f"key mask (valid {valid.long().tolist()}), recorded at the wrapper; CUDA-graph "
                 "replays", launches_are="one window batch of four (7 stages x 12 layers)")]
    per = []
    for shape, (x, alpha, n) in sorted(win["snake_shapes"].items()):
        numel = x.numel()
        t_ops, t_bytes = 6.0 * numel / PEAK_F32, (8.0 * numel + 4 * shape[2]) / HBM
        per.append({"shape": shape, "launches": n,
                    "ms": graph_ms(lambda: snake_mod.snake(x, alpha)),
                    "plain_ms": graph_ms(lambda: snake_mod.snake_ref(x, alpha)),
                    "bound_ms": max(t_ops, t_bytes) * 1e3,
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes"})
    tot = sum(p["launches"] for p in per)

    def mean(key):
        return sum(p[key] * p["launches"] for p in per) / tot
    log(f"timing valle snake ({card}): " + json.dumps(per))
    rows.append(_row("snake_valle", "snake.cu", 78, win["launches"]["snake"], 0.0, mean("ms"),
                     mean("plain_ms"), mean("bound_ms"),
                     max(("bytes", "operations"),
                         key=lambda kk: sum(p["bound_by"] == kk for p in per)), None,
                     ms_is="mean per launch over one window batch's 145 (4 codec encodes of "
                           "4 s prompts, 1 batched decode), each shape on its recorded input, "
                           "CUDA-graph replays", per_shape=per))
    # #4/#5: one decode step's 48 projections at M = 4, and each projection type apart
    g = torch.Generator(DEV).manual_seed(21)
    m = ENGINE_SLOTS
    xs = {kk: torch.randn((m, kk), generator=g, device=DEV).bfloat16()
          for kk in (VALLE_HIDDEN, VALLE_FFN)}

    def projections(mdl):
        for i in range(VALLE_LAYERS):
            layer = getattr(mdl.ar, f"layer_{i}")
            yield from (layer.attn.qkv_proj, layer.attn.o_proj, layer.mlp.gateup_proj,
                        layer.mlp.down_proj)

    for name, mdl, mm, ref, line, src, launches in (
            ("int8_matmul", eng["svc"].model, int8_matmul, int8_matmul_ref, 511,
             "int8_matmul.cu", eng["launches"]["int8_matmul"]),
            ("int4_matmul", quant["m4"], int4_matmul, int4_matmul_ref, 679, "int4_matmul.cu",
             quant["int4_launches"]["int4_matmul"])):
        mods = list(projections(mdl))
        i4 = name == "int4_matmul"

        def k_in(qd):
            return qd.kernel_q.shape[1] * (2 if i4 else 1)

        def call(fn, qd, x=None):
            x = xs[k_in(qd)] if x is None else x
            extra = (qd.group,) if i4 else ()
            return fn(x, qd.kernel_q, qd.scale, *extra, out_dtype=torch.bfloat16)

        def nbytes(sub, rows):
            return sum(qd.kernel_q.numel() + 4 * qd.scale.numel()
                       + 2 * rows * (k_in(qd) + qd.kernel_q.shape[0]) for qd in sub)

        def ops(sub, rows):
            return sum(2.0 * rows * k_in(qd) * qd.kernel_q.shape[0] for qd in sub)

        def library(sub):
            """``torch._weight_int8pack_mm`` / ``_weight_int4pack_mm`` over
            ``sub``, or None where it is missing or disagrees."""
            try:
                if i4:
                    from amphion_tpu_torch.ops.kernels.int4_matmul import unpack_int4

                    def pack(qd):
                        u = unpack_int4(qd.kernel_q).to(torch.int32) + 8
                        w = torch._convert_weight_to_int4pack(
                            ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 8)
                        sz = torch.stack([qd.scale, torch.zeros_like(qd.scale)], -1).bfloat16()
                        return w, qd.group, sz
                    args, fn = [pack(qd) for qd in sub], torch._weight_int4pack_mm
                else:
                    args = [(qd.kernel_q, qd.scale.bfloat16()) for qd in sub]
                    fn = torch._weight_int8pack_mm
                want = call(ref, sub[0]).float()
                err = (fn(xs[k_in(sub[0])], *args[0]).float() - want).abs().max().item()
                if err > 2e-2 * want.abs().max().item():
                    log(f"timing valle {name}: the library call disagrees ({err:.3g})")
                    return None
                return graph_ms(lambda: [fn(xs[k_in(qd)], *a) for qd, a in zip(sub, args)])
            except (RuntimeError, AttributeError, NotImplementedError) as e:
                log(f"timing valle {name}: no library call: {str(e)[:160]}")
                return None

        per_proj = {}
        for j, label in enumerate(("qkv", "o", "gateup", "down")):
            sub = mods[j::4]
            per_proj[label] = {
                "K": k_in(sub[0]), "N": sub[0].kernel_q.shape[0],
                "us": graph_ms(lambda: [call(mm, qd) for qd in sub]) / len(sub) * 1e3,
                "bound_us": _bound(ops(sub, m), nbytes(sub, m))[0] / len(sub) * 1e3,
                "library_us": (lambda t: None if t is None else t / len(sub) * 1e3)(library(sub))}
        k_ms = graph_ms(lambda: [call(mm, qd) for qd in mods])
        p_ms = graph_ms(lambda: [call(ref, qd) for qd in mods], iters=5)
        bound, by = _bound(ops(mods, m), nbytes(mods, m))
        lib = library(mods)
        err = quant["int4_err" if i4 else "int8_err"]
        log(f"timing valle {name} ({card}): one decode step (48 projections, M={m}) kernel "
            f"{k_ms} ms, plain {p_ms} ms, library {lib} ms, bound {bound} ms ({by}); by "
            f"projection (12 layers' weights each): {json.dumps(per_proj)}")
        rows.append(_row(f"{name}_valle", src, line, launches, err, k_ms, p_ms, bound, by, lib,
                         ms_is=f"one VALL-E decode step's 48 projections at M={m}, CUDA-graph "
                               "replays", per_projection=per_proj,
                         launches_are=("the int8 engine run (graph replays counted)" if not i4
                                       else "a 64-step int4 solo decode of request 0")))
    # the head GEMV at N = 1025
    x = torch.randn((m, VALLE_HIDDEN), generator=g, device=DEV).bfloat16()
    w = eng["svc"].model.ar_head.weight.detach()
    hb, hby = _bound(2.0 * m * w.numel(), 2 * (w.numel() + m * VALLE_HIDDEN + m * w.shape[0]))
    h_ms, h_plain = graph_ms(lambda: bf16_linear(x, w)), graph_ms(lambda: bf16_linear_ref(x, w))
    h_lib = graph_ms(lambda: F.linear(x, w))
    log(f"timing valle bf16_gemv ({card}): ({m}, {VALLE_HIDDEN}) x ({w.shape[0]}, "
        f"{VALLE_HIDDEN}) bf16, kernel {h_ms} ms, plain {h_plain} ms, F.linear {h_lib} ms, "
        f"bound {hb} ms ({hby})")
    row = _row("bf16_gemv_valle", "bf16_gemv.cu", 0, eng["launches"]["bf16_gemv"],
               quant["head_err"], h_ms, h_plain, hb, hby, h_lib,
               ms_is=f"one call at the engine's {m}-row step, the 1025-wide head, CUDA-graph "
                     "replays", launches_are="the int8 engine run (graph replays counted)")
    row["replaces"] = ("amphion_tpu/models/tts/valle/valle.py:208 (ar_head, computed by XLA "
                       "there: no Pallas kernel)")
    rows.append(row)
    return rows


def valle_cli_check(path: str, root: str) -> dict:
    """`bins/tts/inference.py` in VALLE mode as a user runs it (the CLI's
    defaults: bf16 AR, top-k 50, seed 0; ``--max_new 256``) on the phase's
    checkpoints: the wav holds max(gen_len, 1) codec frames of 240 samples,
    gen_len as the run's own AR decode returned it."""
    from amphion_tpu_torch.bins.tts import inference as tts_cli
    from amphion_tpu_torch.data.audio_io import load_wav, save_wav

    prompt = os.path.join(root, "prompt.wav")
    save_wav(prompt, synth_audio(np.random.default_rng(304), 3.7), SR)
    lengths = []
    real = tts_cli.ar_generate

    def recording(*a, **kw):
        out = real(*a, **kw)
        lengths.append(int(out[1][0]))
        return out
    tts_cli.ar_generate = recording
    out_wav = os.path.join(root, "valle_cli.wav")
    t0 = time.perf_counter()
    try:
        tts_cli.main(["--config", path, "--exp_name", "valle", "--codec_ckpt",
                      os.path.join(root, "codec"), "--prompt_audio", prompt, "--prompt_text",
                      VALLE_TEXTS[2][0], "--text", VALLE_TEXTS[2][1], "--output_path", out_wav,
                      "--max_new", "256", "--device", DEV])
    finally:
        tts_cli.ar_generate = real
    wall = time.perf_counter() - t0
    wav, sr = load_wav(out_wav)
    want = max(lengths[0], 1) * 240
    check("valle CLI (bins/tts/inference.py, model_type VALLE): a 24 kHz wav of max(gen_len, 1) "
          "x 240 samples", sr == SR and len(wav) == want and np.abs(wav).max() > 1e-3,
          f"{len(wav)} samples at {sr} Hz (want {want}: gen_len {lengths[0]} of 256), "
          f"{wall:.1f} s")
    return {"wall_s": wall, "gen_len": lengths[0], "samples": len(wav)}


def valle_phase(seed: int, kernels: dict, max_new: int) -> dict:
    """VALL-E as `bins/serve.py --backend valle` serves it, at the width of
    `egs/tts/VALLE/exp_config.json`, random weights from ``seed`` written as
    port checkpoints and loaded by `bins/tts/inference.build_valle` (what
    `_build_valle_service` builds on): (a) the int8 engine, (b) the bf16
    window batch, (d) the kernels on the paths' recorded inputs, (c) the
    HTTP backend, then the TTS CLI in VALLE mode."""
    import logging
    import tempfile

    from amphion_tpu_torch.bins import serve as serve_cli
    from amphion_tpu_torch.bins.tts.inference import build_valle
    from amphion_tpu_torch.utils.config import load_config

    out = {"card": nvidia_smi()}
    with tempfile.TemporaryDirectory(prefix="valle_") as root:
        t0 = time.perf_counter()
        path = valle_write_checkpoints(root, seed)
        out["checkpoints_s"] = time.perf_counter() - t0
        argv = ["--backend", "valle", "--config", path, "--exp_name", "valle",
                "--codec_ckpt", os.path.join(root, "codec"), "--device", DEV, "--port", "0",
                "--max_new", str(max_new)]
        args = serve_cli.parse_args(argv)
        t0 = time.perf_counter()
        model, tok, g2p, symbols = build_valle(args, load_config(path),
                                               logging.getLogger("smoke"), device=DEV)
        out["build_s"] = time.perf_counter() - t0
        c = model.cfg
        check("valle: the model as built from the checkpoints",
              (c.hidden, c.num_layers, c.num_heads, c.audio_vocab, c.num_quantizers)
              == (VALLE_HIDDEN, VALLE_LAYERS, 16, 1024, 8)
              and model.ar.cfg.ffn_dim == VALLE_FFN and tok.hop == 240,
              f"{c}, FFN {model.ar.cfg.ffn_dim}, codec hop {tok.hop}, parameters "
              f"{sum(p.numel() for p in model.parameters())}")
        eng = valle_engine_phase(model, tok, g2p, symbols, kernels, max_new)
        eng["svc"].shutdown()
        win = valle_window_phase(model, tok, g2p, symbols, kernels, max_new)
        quant = valle_quant_phase(eng["rec"], eng["head_calls"], model, eng["reqs"], kernels)
        rows = valle_kernel_rows(win, quant, eng, model)
        out.update(engine=eng["perf"], window={k: v for k, v in win.items()
                                               if k not in ("flash_calls", "snake_shapes")},
                   int4_launches=quant["int4_launches"])
        del model, tok, eng, win, quant
        gc.collect()
        torch.cuda.empty_cache()
        out["http"] = valle_http_phase(args, kernels)
        out["cli"] = valle_cli_check(path, root)
    log(f"valle ({out['card']}): " + json.dumps(
        {k: v for k, v in out.items() if k in ("checkpoints_s", "build_s", "int4_launches",
                                               "cli")}))
    out["rows"] = rows
    return out


# -- codec-LM training: bins/tts/{preprocess,train}.py --------------------------------

TTS_CLIPS = 96  # 95 train + 1 test (the adapter's 2 % split, one at least)
# 3.2-3.45 s: the codes (100 Hz) all in bucket 410, 39 rows a batch; the semantic
# tokens (200 Hz) all in bucket 693, 23 rows a batch (rows cut to the codes, JAX's rule)
TTS_SECONDS = (3.2, 3.45)
TTS_STEPS, TTS_SAVE = 4, 2  # steps of the run; the checkpoint the resume starts from
TTS_MAX_NEW = 64  # the VALL-E CLI's AR steps from the trained checkpoint
TTS_MODELS = {  # name → (recipe, preprocess switches, attention layers a step: forward + backward)
    "valle": (VALLE_CONFIG, ["--extract_codes"], 2 * 12),
    "maskgct": (MG_CONFIG, ["--extract_codes", "--extract_semantic"], 2 * MG_LAYERS),
}
TTS_WORDS = ("the a of and to in is was he for it with as his on be at by had not are but "
             "from or have an they which one you were her all she there would their we him "
             "been has when who will more no if out so said what up its about into than them "
             "can only other new some could time these two may then do first any my now such "
             "like our over man me even most made after also did many before must through back "
             "years where much your way well down should because each just those people mister "
             "how too little state good very make world still own see men work long get here "
             "between both life being under never day same another know while last might us "
             "great old year off come since against go came right used take three").split()


def tts_corpus(root, seed: int) -> list:
    """``TTS_CLIPS`` seeded clips in LibriTTS's layout
    (<split>/<spk>/<chapter>/<uid>.wav beside <uid>.normalized.txt), each a
    sentence of 7-11 common words → [(wav path, text)]."""
    from amphion_tpu_torch.data.audio_io import save_wav

    rng = np.random.default_rng(seed + 41)
    out = []
    for i in range(TTS_CLIPS):
        spk, chap = 100 + i % 4, 10 + i % 3
        d = root / "raw" / "train-clean-100" / str(spk) / str(chap)
        d.mkdir(parents=True, exist_ok=True)
        uid = f"{spk}_{chap}_{i:06d}"
        save_wav(d / f"{uid}.wav", synth_audio(rng, float(rng.uniform(*TTS_SECONDS))), SR)
        text = " ".join(rng.choice(TTS_WORDS, int(rng.integers(7, 12)))).capitalize() + "."
        (d / f"{uid}.normalized.txt").write_text(text)
        out.append((str(d / f"{uid}.wav"), text))
    return out


def tts_config(root, name: str, run: str, **train) -> str:
    """The recipe of ``name`` at its published widths and ``max_tokens``
    (16 000), over the corpus, with phones on (`config/base.json` sets
    them off), a log dir and a metrics file under ``root``."""
    cfg = {"base_config": os.path.abspath(TTS_MODELS[name][0]), "dataset": ["libritts"],
           "dataset_path": {"libritts": str(root / "raw")}, "log_dir": str(root / "ckpts"),
           "preprocess": {"processed_dir": str(root / name / "processed"),
                          "extract_phone": True},
           "train": {"log_interval": 1, "metrics_path": str(root / f"{name}_{run}.jsonl"),
                     **train}}
    path = root / f"{name}_{run}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def tts_codecs(root, name: str, cfg_path: str, seed: int) -> list:
    """Port checkpoints of the recipe's Amphion codec (`mg_codec_unsaturated`)
    and, for MaskGCT, of its semantic RepCodec, from random weights of
    ``seed``, shared by preprocessing and inference → their CLI flags."""
    import types

    from amphion_tpu_torch.bins.tts.inference import _codec_config
    from amphion_tpu_torch.bins.tts.preprocess import semantic_codec_config
    from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec
    from amphion_tpu_torch.models.codec.repcodec import RepCodec
    from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
    from amphion_tpu_torch.utils.config import load_config
    from amphion_tpu_torch.utils.convert import init_like_flax

    cfg = load_config(cfg_path)
    g = torch.Generator(DEV).manual_seed(seed + 43)
    modules = {"codec": lambda: AmphionCodec(_codec_config(cfg))}
    if "--extract_semantic" in TTS_MODELS[name][1]:
        modules["semantic"] = lambda: RepCodec(semantic_codec_config(cfg), with_decode=True)
    flags = []
    for key, make in modules.items():
        with torch.device(DEV):
            module = init_like_flax(make(), g)
        if key == "codec":
            mg_codec_unsaturated(module, g)
        where = root / name / key
        state = types.SimpleNamespace(state_dict=lambda m=module: {"model": m.state_dict()})
        CheckpointManager(where).save(state, 1, 0, 0.0)
        flags += [f"--{key}_ckpt", str(where)]
    return flags


def first_of_each_shape():
    """A `CallRecorder` pick that keeps a call whose first argument's shape
    is new to it."""
    seen = set()

    def keep(i: int, args) -> bool:
        shape = tuple(args[0].shape)
        if shape in seen:
            return False
        seen.add(shape)
        return True
    return keep


def tts_preprocess_kernel_checks(name: str, snake_calls: list, mel_calls: list) -> dict:
    """Kernels 1 and 3 on the preprocessing's own inputs (the first call of
    each shape, recorded at their wrappers): #1 bit-equal to `snake_ref`,
    #3 within 1e-3 of `log_mel_ref` (the MaskGCT phase's rules), each
    bit-equal on a relaunch."""
    from amphion_tpu_torch.ops import mel as mel_ops
    from amphion_tpu_torch.ops.kernels import snake as snake_mod
    from amphion_tpu_torch.ops.kernels.mel import log_mel_ref

    bad1, worst1 = [], 0.0
    for i, (x, alpha) in snake_calls:
        got, ref = snake_mod.snake(x, alpha), snake_mod.snake_ref(x, alpha)
        worst1 = max(worst1, (got - ref).abs().max().item())
        if not (torch.equal(got, ref) and torch.equal(snake_mod.snake(x, alpha), got)):
            bad1.append((i, tuple(x.shape)))
    shapes1 = sorted({tuple(x.shape) for _, (x, _) in snake_calls})
    check(f"tts preprocess {name} #1: the codec encoder's calls bit-equal to snake_ref",
          bool(snake_calls) and not bad1,
          f"{len(snake_calls)} shapes from {shapes1[0] if shapes1 else None} to "
          f"{shapes1[-1] if shapes1 else None}, max|err| {worst1:.3g}; not bit-equal or not "
          f"equal on relaunch: {bad1}")
    bad3, worst3 = [], 0.0
    for i, (y, fb, n_fft, hop, win, clip) in mel_calls:
        got = mel_ops.log_mel(y, fb, n_fft, hop, win, clip)
        err = (got - log_mel_ref(y, fb, n_fft, hop, win, clip)).abs().max().item()
        worst3 = max(worst3, err)
        again = torch.equal(mel_ops.log_mel(y, fb, n_fft, hop, win, clip), got)
        if not (err <= 1e-3 and again):
            bad3.append((i, tuple(y.shape), err, again))
    check(f"tts preprocess {name} #3: the mel and semantic front ends' calls against "
          "log_mel_ref (tol 1e-3)", bool(mel_calls) and not bad3,
          f"{len(mel_calls)} shapes, the largest "
          f"{max((tuple(y.shape) for _, (y, *_) in mel_calls), default=None)}, max|err| "
          f"{worst3:.3g}; failing (call, shape, err, relaunch bit-equal): {bad3}")
    return {"snake": worst1, "mel": worst3, "snake_shapes": len(snake_calls),
            "mel_shapes": len(mel_calls)}


def tts_preprocess(root, name: str, cfg_path: str, ckpt_flags: list, kernels: dict) -> dict:
    """`bins/tts/preprocess.py` as the recipe's stage 1 runs it, in process:
    the launches (kernel 3: one a batch of the acoustic features, and one a
    file for the semantic tokens; kernel 1: the 29 activations of a codec
    encoder pass a file; no other kernel), every file's features, and
    kernels 1 and 3 held to their plain versions on the first call of each
    shape (`tts_preprocess_kernel_checks`)."""
    import inspect

    from amphion_tpu_torch.bins.tts import preprocess as pre
    from amphion_tpu_torch.data.audio_io import load_wav
    from amphion_tpu_torch.data.metadata import load_metadata
    from amphion_tpu_torch.data.processors.acoustic import extract_acoustic_features
    from amphion_tpu_torch.data.samplers import LengthBucketSampler
    from amphion_tpu_torch.ops import mel as mel_ops
    from amphion_tpu_torch.ops.kernels import snake as snake_mod

    recs = [CallRecorder(mod, fn, first_of_each_shape())
            for mod, fn in ((snake_mod, "snake"), (mel_ops, "log_mel"))]
    for k in kernels.values():
        k.reset()
    t0 = time.perf_counter()
    try:
        pre.main(["--config", cfg_path, *TTS_MODELS[name][1], *ckpt_flags, "--device", DEV])
        torch.cuda.synchronize()
    finally:
        for rec in recs:
            rec.remove()
    wall = time.perf_counter() - t0
    got = {n: k.launches for n, k in kernels.items()}
    d = root / name / "processed" / "libritts"
    utts = load_metadata(d / "train.json") + load_metadata(d / "test.json")
    semantic = "--extract_semantic" in TTS_MODELS[name][1]
    lengths = [max(len(load_wav(u.path, sr=SR)[0]) // HOP * HOP, HOP) for u in utts]
    budget = inspect.signature(extract_acoustic_features).parameters["max_tokens"].default
    batches = len(LengthBucketSampler(lengths, max_tokens=budget, shuffle=False))
    want = {n: 0 for n in kernels}
    want.update(mel=batches + (len(utts) if semantic else 0),
                snake=MG_SNAKE_PER_PASS * len(utts))
    check(f"tts preprocess {name}: launches", got == want,
          f"{got} (predicted {want}: {batches} acoustic batches, {len(utts)} files)")
    bad = []
    for u, n in zip(utts, lengths):
        frames = n // 240  # the codec's hop
        codes = np.load(d / "codes" / f"{u.uid}.npy")
        ok = codes.shape == (8 if name == "valle" else 12, frames) and (
            d / "phones" / f"{u.uid}.json").is_file() and (d / "mels" / f"{u.uid}.npy").is_file()
        if semantic:
            sem, lat = (np.load(d / s / f"{u.uid}.npy") for s in ("semantic", "semantic_feats"))
            ok = ok and sem.shape == (n // HOP,) and lat.shape == (n // HOP, 384) and bool(
                np.isfinite(lat).all())
        if not ok:
            bad.append(u.uid)
    check(f"tts preprocess {name}: every file's features", not bad and len(utts) == TTS_CLIPS,
          f"{len(utts)} files ({len(utts) - len(bad)} complete: phones, mels, codes (Q, N)"
          + (", semantic tokens (2N,) and latents (2N, 384)" if semantic else "") + ")")
    errs = tts_preprocess_kernel_checks(name, recs[0].calls, recs[1].calls)
    per_file = {"mel": got["mel"] / len(utts), "snake": got["snake"] / len(utts)}
    log(f"tts preprocess {name}: {len(utts)} files in {wall:.1f} s; launches {got}, a file "
        f"{per_file}; against the plain versions {errs}")
    return {"wall_s": wall, "files": len(utts), "launches": got, "per_file": per_file,
            "max_abs_err": {"snake": errs["snake"], "mel": errs["mel"]}}


def tts_batches(trainer, steps: int) -> list:
    """The (indices, bucket) batches of a run's first ``steps`` steps."""
    out, epoch = [], 0
    while len(out) < steps:
        out += trainer.epoch_batches(epoch)
        epoch += 1
    return out[:steps]


def tts_train(root, name: str, kernels: dict, flash_keep) -> dict:
    """The recipe through `bins/tts/train.main` on the card: ``TTS_STEPS``
    steps with a checkpoint at ``TTS_SAVE``; then a resume from it in a run
    directory of its own for the remaining steps, with the flash wrapper's
    calls picked by ``flash_keep`` recorded. Launch counts are set to 0
    just before each run and read just after: kernels 6 and 7 once a layer
    a step (AR + NAR, or T2S + S2A), no other kernel. The resumed run's
    losses and final weights must equal the whole run's to the bit."""
    import shutil

    from amphion_tpu_torch.bins.tts.train import main as train_main
    from amphion_tpu_torch.modules import llama as llama_mod
    from amphion_tpu_torch.runtime.checkpoint import CheckpointManager

    per_step = TTS_MODELS[name][2]
    cfg = tts_config(root, name, "run", max_steps=TTS_STEPS, save_checkpoints_steps=TTS_SAVE)
    for k in kernels.values():
        k.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_main(["--config", cfg, "--exp_name", name, "--device", DEV])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    want = {n: 0 for n in kernels}
    want.update(flash_attn_fwd=per_step * TTS_STEPS, flash_attn_bwd=per_step * TTS_STEPS)
    check(f"tts train {name}: launches", launches == want,
          f"{launches} (predicted {want}: {per_step} attention layers x {TTS_STEPS} steps)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    model = trainer.loop.states.model
    n_params = sum(p.numel() for p in model.parameters())
    rows = metrics(root, f"{name}_run")
    loss_keys = [k for k in rows[0] if k.endswith("_loss")]
    check(f"tts train {name}: losses", len(rows) == TTS_STEPS and all(
        math.isfinite(r[k]) for r in rows for k in loss_keys + ["loss"]),
        f"{[{k: r[k] for k in ['loss'] + loss_keys} for r in rows]}")
    # tokens a step: the batch's code frames (VALL-E) or its rows' cut lengths (MaskGCT)
    real, padded = [], []
    for indices, bucket in tts_batches(trainer, TTS_STEPS):
        batch = trainer.make_batch(indices, bucket)
        mask = batch["token_mask"] if name == "valle" else batch["x_mask"]
        real.append(float(mask.sum()))
        padded.append(mask.numel())
    secs = [r["step_s"] for r in rows]
    med = statistics.median(secs[1:])
    perf = {"params": n_params, "step_s": secs, "median_step_s": med,
            "tokens": real, "padded_positions": padded,
            "tokens_per_s": statistics.median(t / s for t, s in zip(real[1:], secs[1:])),
            "padded_positions_per_s": statistics.median(
                p / s for p, s in zip(padded[1:], secs[1:])),
            "launches_per_step": {n: launches[n] / TTS_STEPS
                                  for n in ("flash_attn_fwd", "flash_attn_bwd")},
            "max_memory_allocated_gib": peak, "run_wall_s": wall}
    log(f"tts train {name} perf ({nvidia_smi()}): {n_params / 1e6:.1f} M params, float32; "
        f"median step {med:.4f} s over steps 2-{TTS_STEPS}, {perf['tokens_per_s']:.0f} tokens/s "
        f"({perf['padded_positions_per_s']:.0f} padded positions/s), peak {peak:.2f} GiB; "
        + json.dumps(perf))
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()

    ckdir = root / "ckpts" / name / "checkpoint"
    start = next(p for p in ckdir.glob("epoch-*") if f"_step-{TTS_SAVE:07d}_" in p.name)
    cfg2 = tts_config(root, name, "resume", max_steps=TTS_STEPS, save_checkpoints_steps=0)
    rec = CallRecorder(llama_mod, "flash_attention", flash_keep)
    for k in kernels.values():
        k.reset()
    try:
        again = train_main(["--config", cfg2, "--exp_name", f"{name}_resume", "--resume",
                            "--resume_from_ckpt_path", str(start), "--device", DEV])
        torch.cuda.synchronize()
    finally:
        rec.remove()
    got = {n: k.launches for n, k in kernels.items()}
    want.update(flash_attn_fwd=per_step * (TTS_STEPS - TTS_SAVE),
                flash_attn_bwd=per_step * (TTS_STEPS - TTS_SAVE))
    rerun = metrics(root, f"{name}_resume")
    first = rows[TTS_SAVE:]
    same_losses = [[r[k] for k in loss_keys] for r in rerun] == [
        [r[k] for k in loss_keys] for r in first]
    del again
    gc.collect()
    torch.cuda.empty_cache()
    states = [CheckpointManager(root / "ckpts" / n / "checkpoint").restore_raw(
        map_location="cpu") for n in (name, f"{name}_resume")]
    a, b = states[0][0]["model"], states[1][0]["model"]
    same_weights = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    check(f"tts train {name}: resume", same_losses and same_weights and got == want
          and states[0][2] == states[1][2] == TTS_STEPS,
          f"steps {TTS_SAVE + 1}-{TTS_STEPS} from the step-{TTS_SAVE} checkpoint: losses "
          f"bit-equal {same_losses} ({[[r[k] for k in loss_keys] for r in rerun]}), step-"
          f"{TTS_STEPS} weights bit-equal {same_weights}; launches {got} (predicted {want})")
    del states, a, b
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root / "ckpts" / f"{name}_resume", ignore_errors=True)
    shutil.rmtree(start, ignore_errors=True)
    calls = [tuple(x.detach() if torch.is_tensor(x) else x for x in args)
             for _, args in rec.calls]
    return {"perf": perf, "launches": launches, "calls": calls, "loss_keys": loss_keys,
            "losses": [[r[k] for k in loss_keys] for r in rows]}


def tts_cli(root, name: str, ckpt_flags: list, clip: tuple, text: str) -> dict:
    """`bins/tts/inference.py` in the recipe's mode from the trained
    checkpoint (``log_dir/<name>/checkpoint``), the corpus's codecs, a
    training clip as the prompt: a finite 24 kHz wav of whole codec frames
    (VALL-E: at most ``TTS_MAX_NEW`` of them)."""
    from amphion_tpu_torch.bins.tts import inference as tts_cli_mod
    from amphion_tpu_torch.data.audio_io import load_wav

    out = str(root / f"{name}_cli.wav")
    argv = ["--config", tts_config(root, name, "cli"), "--exp_name", name, *ckpt_flags,
            "--prompt_audio", clip[0], "--prompt_text", clip[1], "--text", text,
            "--output_path", out, "--device", DEV]
    if name == "valle":
        argv += ["--max_new", str(TTS_MAX_NEW)]
    t0 = time.perf_counter()
    tts_cli_mod.main(argv)
    wall = time.perf_counter() - t0
    wav, sr = load_wav(out)
    most = TTS_MAX_NEW * 240 if name == "valle" else math.inf
    check(f"tts {name} CLI from the trained checkpoint (bins/tts/inference.py)",
          sr == SR and 240 <= len(wav) <= most and len(wav) % 240 == 0
          and bool(np.isfinite(wav).all()),
          f"{len(wav)} samples at {sr} Hz ({len(wav) // 240} frames), max|x| "
          f"{float(np.abs(wav).max()):.3g}, {wall:.1f} s")
    return {"wall_s": wall, "samples": len(wav)}


def tts_flash_shapes(valle: dict, mg: dict) -> dict:
    """The recorded training calls of kernel 6 (layer 0 of each model, the
    resumed run's first step) by name → (q, k, v, mask, causal)."""
    (ar, nar), (t2s, s2a) = valle["calls"], mg["calls"]
    return {"valle_ar": ar[:5], "valle_nar": nar[:5], "maskgct_t2s": t2s[:5],
            "maskgct_s2a": s2a[:5]}


def tts_flash_rows(shapes: dict, launches: dict, per_step: dict) -> list:
    """Kernels 6 and 7 at the four recorded training shapes, float32 with
    each batch's key mask (VALL-E's AR causal too), relaunched bit for bit
    and held to float64 autograd (`dense_attention64`) from a seeded dO:
    the output and dq, dk, dv within 1e-4 of max|ref64|, or no further from
    float64 than the plain float32 version is (at these lengths and
    activations, up to 30, float32 sums alone come near 1e-4); then timed
    by graph replays beside the plain version and SDPA with the same mask
    (`bwd_timing_phase`'s bounds: 4 D (forward) or 10 D (backward)
    operations an attended pair at the float32 rate, or the bytes once at
    the HBM rate; and ``*_bound_3xtf32_ms``, the same operations as three
    TF32 products at the TF32 rate, as the kernels do them). The AR's mask
    must hold padding holes: a row's padded phones between its real phones
    and its codes."""
    from amphion_tpu_torch.ops.kernels import flash_attention as flash_mod

    ar_mask = shapes["valle_ar"][3]
    real = ar_mask > 0
    holes = int(((~real[:, :-1]) & real[:, 1:]).any(dim=1).sum())
    check("tts flash: the AR's key mask has padding holes (causal + key mask)", holes > 0,
          f"{holes} of {ar_mask.shape[0]} rows with a masked key before a real one")
    g = torch.Generator(DEV).manual_seed(47)
    per, errs = [], {"fwd": 0.0, "bwd": 0.0}
    for name, (q, k, v, mask, causal) in shapes.items():
        b, L, h, d = q.shape
        with torch.no_grad():
            out, lse = flash_mod.flash_attention(q, k, v, mask, causal, return_lse=True)
            again = flash_mod.flash_attention(q, k, v, mask, causal, return_lse=True)
            plain = flash_mod.attention_ref(q, k, v, mask, causal)
            do = torch.randn(q.shape, generator=g, device=DEV)
            grads = flash_mod.flash_attention_bwd(q, k, v, mask, out, lse, do, causal)
            grads2 = flash_mod.flash_attention_bwd(q, k, v, mask, out, lse, do, causal)
            plain_grads = flash_mod.flash_attention_bwd_ref(q, k, v, mask, out, lse, do, causal)
        leaves = [x.double().requires_grad_() for x in (q, k, v)]
        ref = dense_attention64(*leaves, mask, causal)
        refs = torch.autograd.grad(ref, leaves, do.double())
        ref = ref.detach()
        del leaves
        torch.cuda.synchronize()

        def rel(a, r):
            return (a.double() - r).abs().max().item() / r.abs().max().item()
        e_f, p_f = rel(out, ref), rel(plain, ref)
        e_b = [rel(a, r) for a, r in zip(grads, refs)]
        p_b = [rel(a, r) for a, r in zip(plain_grads, refs)]
        ok = e_f <= max(1e-4, p_f) and all(e <= max(1e-4, p) for e, p in zip(e_b, p_b))
        same = torch.equal(out, again[0]) and all(torch.equal(a, b_) for a, b_ in
                                                  zip(grads, grads2))
        check(f"tts flash {name} ({b}, {L}, {h}, {d}) f32 causal={causal}", ok and same,
              f"max|err|/max|ref64|: output {e_f:.3g} (plain {p_f:.3g}); dq, dk, dv "
              f"{[f'{e:.3g}' for e in e_b]} (plain {[f'{e:.3g}' for e in p_b]}); tol 1e-4 or "
              f"the plain version's; bit-equal on relaunch: {same}")
        errs["fwd"] = max(errs["fwd"], (out.double() - ref).abs().max().item())
        errs["bwd"] = max(errs["bwd"], max((a.double() - r).abs().max().item()
                                           for a, r in zip(grads, refs)))
        del ref, refs, plain, plain_grads, grads2, again
        fwd = lambda: flash_mod.flash_attention(q, k, v, mask, causal, return_lse=True)  # noqa: E731
        bwd = lambda: flash_mod.flash_attention_bwd(q, k, v, mask, out, lse, do, causal)  # noqa: E731
        allowed = (mask > 0)[:, None, :].expand(b, L, L)
        if causal:
            allowed = allowed & torch.ones((L, L), dtype=torch.bool, device=DEV).tril()
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt.detach(), kt.detach(), vt.detach(), attn_mask=allowed[:, None])
        f_ms, b_ms, f_lib = graph_ms(fwd), graph_ms(bwd), graph_ms(sdpa_fwd)
        f_plain = graph_ms(lambda: flash_mod.attention_ref(q, k, v, mask, causal,
                                                           return_lse=True), iters=3)
        b_plain = graph_ms(lambda: flash_mod.flash_attention_bwd_ref(
            q, k, v, mask, out, lse, do, causal), iters=3)
        b_lib, method, backend = sdpa_bwd_ms(qt, kt, vt, allowed, do.transpose(1, 2))
        pairs = float(allowed.sum()) * h
        f_bytes, b_bytes = 4.0 * (4 * b * L * h * d + b * h * L), 4.0 * (8 * b * L * h * d
                                                                         + b * h * L)
        f_ops, b_ops = 4.0 * d * pairs, 10.0 * d * pairs
        f_bound = max(f_ops / PEAK_F32, f_bytes / HBM) * 1e3
        b_bound = max(b_ops / PEAK_F32, b_bytes / HBM) * 1e3
        f_bound_tc = max(3 * f_ops / PEAK_TF32, f_bytes / HBM) * 1e3
        b_bound_tc = max(3 * b_ops / PEAK_TF32, b_bytes / HBM) * 1e3
        entry = {"shape": name, "b_l_h_d": [b, L, h, d], "causal": causal,
                 "valid_keys": (mask > 0).sum(dim=1).long().tolist(), "pairs": pairs,
                 "fwd_ms": f_ms, "fwd_plain_ms": f_plain, "fwd_library_ms": f_lib,
                 "fwd_bound_ms": f_bound, "fwd_bound_3xtf32_ms": f_bound_tc,
                 "fwd_bound_by": "operations" if f_ops / PEAK_F32 >= f_bytes / HBM else "bytes",
                 "bwd_ms": b_ms, "bwd_plain_ms": b_plain, "bwd_library_ms": b_lib,
                 "bwd_library_backend": backend, "bwd_library_timing": method,
                 "bwd_bound_ms": b_bound, "bwd_bound_3xtf32_ms": b_bound_tc,
                 "bwd_bound_by": "operations" if b_ops / PEAK_F32 >= b_bytes / HBM else "bytes",
                 "fwd_err_vs_f64": e_f, "fwd_plain_err_vs_f64": p_f,
                 "bwd_err_vs_f64": e_b, "bwd_plain_err_vs_f64": p_b}
        per.append(entry)
        log(f"timing tts flash {name} ({b}, {L}, {h}, {d}) f32 causal={causal} (graph replays, "
            f"{nvidia_smi()}): forward with LSE {f_ms:.5f} ms (plain {f_plain:.5f}, SDPA "
            f"{f_lib:.5f}, bound {f_bound:.5f}, 3xTF32 bound {f_bound_tc:.5f}); backward "
            f"{b_ms:.5f} ms (plain {b_plain:.5f}, SDPA {backend} {method} {b_lib:.5f}, bound "
            f"{b_bound:.5f}, 3xTF32 bound {b_bound_tc:.5f})")
        del qt, kt, vt, allowed
    head = per[0]
    common = dict(shape=f"valle_ar {tuple(head['b_l_h_d'])} f32 causal with the batch's key "
                        "mask; per_shape: every recorded training shape",
                  launches_per_step=per_step, per_shape=per,
                  launches_are=f"the two runs of {TTS_STEPS} steps (VALL-E, MaskGCT) at the "
                               "recipes' max_tokens, counted at the wrappers",
                  timing="CUDA-graph replays on the resumed run's recorded layer-0 inputs")
    rows = [_row("flash_attn_fwd_tts_training", "flash_attn_fwd.cu", 843,
                 launches["flash_attn_fwd"], errs["fwd"], head["fwd_ms"], head["fwd_plain_ms"],
                 head["fwd_bound_ms"], head["fwd_bound_by"], head["fwd_library_ms"],
                 bound_3xtf32_ms=head["fwd_bound_3xtf32_ms"], **common),
            _row("flash_attn_bwd_tts_training", "flash_attn_bwd.cu", 1044,
                 launches["flash_attn_bwd"], errs["bwd"], head["bwd_ms"], head["bwd_plain_ms"],
                 head["bwd_bound_ms"], head["bwd_bound_by"], head["bwd_library_ms"],
                 bound_3xtf32_ms=head["bwd_bound_3xtf32_ms"], also_replaces="amphion_tpu/ops/pallas_kernels.py:1073", **common)]
    return rows


def tts_reference_phase(seed: int) -> None:
    """One step of VALL-E and of MaskGCT (T2S + S2A) at full width (1024,
    16 heads) and 2 layers, float32, on the card and on the CPU with the
    same weights, batch and injected draws: phones with padding holes,
    ragged codes, a dropped row in MaskGCT. The loss within 1e-4 relative,
    every gradient within 1e-3 of its tensor's max|ref|."""
    import copy

    from amphion_tpu_torch.models.tts.maskgct.maskgct import (
        MaskGCTS2A, MaskGCTT2S, S2AConfig, T2SConfig)
    from amphion_tpu_torch.models.tts.valle.valle import VALLE, VALLEConfig
    from amphion_tpu_torch.utils.convert import init_like_flax

    gen = torch.Generator().manual_seed(seed + 53)
    rng = np.random.default_rng(seed + 53)
    b, lp, t = 2, 14, 90
    pm = (torch.arange(lp)[None] < torch.tensor([14, 9])[:, None]).float()
    tm = (torch.arange(t)[None] < torch.tensor([90, 71])[:, None]).float()
    phones = torch.from_numpy(rng.integers(1, 64, (b, lp))) * pm.long()
    small = dict(hidden=1024, num_layers=2, num_heads=16)
    codes = {q: torch.from_numpy(rng.integers(0, 1024, (b, q, t))) for q in (8, 12)}
    mask_u = [torch.rand((b, t), generator=gen) for _ in range(2)]
    feats = torch.randn((b, t, 384), generator=gen)
    cases = {
        "valle": (VALLE(VALLEConfig(num_phones=64, **small)),
                  lambda m, dev: m.train_loss(phones.to(dev), pm.to(dev), codes[8].to(dev),
                                              tm.to(dev), stage=torch.tensor([3, 6], device=dev),
                                              plen=11)),
        "maskgct_t2s": (MaskGCTT2S(T2SConfig(phone_vocab=64, **small)),
                        lambda m, dev: m.compute_loss(
                            codes[8][:, 0].to(dev) * 8, tm.to(dev), phones.to(dev), pm.to(dev),
                            t=torch.tensor([0.3, 0.8], device=dev),
                            mask_u=mask_u[0].to(dev), prompt_len=torch.tensor([20, 30], device=dev),
                            use_cond=torch.tensor([True, False], device=dev))),
        "maskgct_s2a": (MaskGCTS2A(S2AConfig(num_quantizers=12, **small), False, True),
                        lambda m, dev: m.compute_loss(
                            codes[12].to(dev), tm.to(dev), feats.to(dev),
                            t=torch.tensor([0.6, 0.2], device=dev), mask_u=mask_u[1].to(dev),
                            prompt_len=torch.tensor([10, 25], device=dev),
                            use_cond=torch.tensor([True, True], device=dev),
                            layer=torch.tensor([2, 9], device=dev))),
    }
    for name, (cpu, loss_fn) in cases.items():
        init_like_flax(cpu, gen)
        with torch.no_grad():  # a conditioning path for the adaptive norms, as trained ones have
            for pname, p in cpu.named_parameters():
                if "to_weight.weight" in pname:
                    p.normal_(0.0, 0.02, generator=gen)
        gpu = copy.deepcopy(cpu).to(DEV)
        res = {}
        for key, m in (("card", gpu), ("cpu", cpu)):
            loss, _ = loss_fn(m, next(m.parameters()).device)
            loss.backward()
            res[key] = (loss.item(), {k: p.grad.cpu() for k, p in m.named_parameters()
                                      if p.grad is not None})
        rel = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        worst, worst_name = 0.0, ""
        for k, ref in res["cpu"][1].items():
            err = (res["card"][1][k] - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
            if err > worst:
                worst, worst_name = err, k
        check(f"reference: {name} step at full width, 2 layers, card vs CPU",
              rel <= 1e-4 and worst <= 1e-3 and res["card"][1].keys() == res["cpu"][1].keys(),
              f"loss {res['card'][0]:.6f} vs {res['cpu'][0]:.6f} (rel {rel:.2g}, tol 1e-4); "
              f"worst gradient {worst_name} max|err|/max|ref| {worst:.2g} (tol 1e-3) over "
              f"{len(res['cpu'][1])} tensors")
        del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()


def tts_training_phase(seed: int, kernels: dict, rows: list) -> dict:
    """Codec-LM training as the recipes run it (egs/tts/{VALLE,MaskGCT}/
    run.sh stages 1-3): a synthetic LibriTTS corpus through
    `bins/tts/preprocess.py`, `bins/tts/train.py` at the recipes' widths
    (VALL-E 1024 x 12 AR + NAR; T2S and S2A 1024 x 16, FFN 4096) and
    ``max_tokens`` 16 000 in float32, a resume, and `bins/tts/inference.py`
    from the trained checkpoints; then kernels 6 and 7 at the recorded
    training shapes (`tts_flash_rows`), whose rows join ``rows``, and the
    preprocessing's launches a file on the mel and Snake rows."""
    import shutil
    import tempfile
    from pathlib import Path

    laps, t0 = {}, time.perf_counter()

    def lap(key: str) -> None:
        nonlocal t0
        laps[key] = laps.get(key, 0.0) + time.perf_counter() - t0
        t0 = time.perf_counter()

    tts_reference_phase(seed)
    lap("card_vs_cpu")
    root = Path(tempfile.mkdtemp(prefix="tts_"))
    out = {}
    try:
        clips = tts_corpus(root, seed)
        lap("corpus")
        for name, (_, _, per_step) in TTS_MODELS.items():
            flags = tts_codecs(root, name, tts_config(root, name, "pre"), seed)
            pre = tts_preprocess(root, name, tts_config(root, name, "pre"), flags, kernels)
            lap(f"{name}_preprocess")
            # layer 0 of each model (AR then NAR, T2S then S2A) in the first step
            keep = functools.partial(lambda layers, i, a: i in (0, layers), per_step // 2)
            run = tts_train(root, name, kernels, keep)
            lap(f"{name}_train_and_resume")
            cli = tts_cli(root, name, flags, clips[0], clips[1][1])
            shutil.rmtree(root / "ckpts" / name, ignore_errors=True)
            lap(f"{name}_cli")
            out[name] = {"preprocess": pre, **run, "cli": cli}
        launches = {k: out["valle"]["launches"][k] + out["maskgct"]["launches"][k]
                    for k in ("flash_attn_fwd", "flash_attn_bwd")}
        per_step = {n: out[n]["perf"]["launches_per_step"]["flash_attn_fwd"] for n in TTS_MODELS}
        rows += tts_flash_rows(tts_flash_shapes(out["valle"], out["maskgct"]), launches,
                               per_step)
        lap("flash_checks_and_timing")
        for r in rows:
            kernel = {"mel_spectrogram": "mel", "snake": "snake"}.get(r["name"])
            if kernel:
                r["tts_preprocess_launches_per_file"] = {
                    n: out[n]["preprocess"]["per_file"][kernel] for n in TTS_MODELS}
                r["tts_preprocess_max_abs_err"] = {
                    n: out[n]["preprocess"]["max_abs_err"][kernel] for n in TTS_MODELS}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("tts training laps (s): " + json.dumps(laps))
    log(f"tts training ({nvidia_smi()}): " + json.dumps(
        {n: {"perf": o["perf"], "preprocess": o["preprocess"], "cli": o["cli"]}
         for n, o in out.items()}))
    return out


# -- VITS and FastSpeech2: the LJSpeech recipes through bins/tts/{preprocess,train,inference}.py

CLASSIC_CLIPS = 49  # 48 train (three batches of 16: three steps are one epoch) + 1 test
CLASSIC_SECONDS = (2.6, 3.4)  # about 3 s: 520-680 linear frames at hop 120 (max_frames 600 cuts)
CLASSIC_STEPS, CLASSIC_SAVE = 3, 2  # steps of the run; the checkpoint the resume starts from
CLASSIC_MODELS = {"vits": "egs/tts/VITS/exp_config.json",
                  "fs2": "egs/tts/FastSpeech2/exp_config.json"}
CLASSIC_MEL_PER_STEP = {"vits": 2, "fs2": 1}  # VITS: mel loss real + fake; FS2: the batch
CLASSIC_ROWS = 4  # the rows of the card-vs-CPU steps (full width; the CPU's time)
CLASSIC_TEXT = "the quick brown fox jumps over the lazy dog"


def classic_corpus(root, seed: int) -> list:
    """``CLASSIC_CLIPS`` seeded 24 kHz clips in LJSpeech's layout
    (``metadata.csv`` of ``id|raw|normalized``, ``wavs/<id>.wav``), each a
    sentence of 7-11 common words → [(uid, text, samples)]."""
    from amphion_tpu_torch.data.audio_io import save_wav

    rng = np.random.default_rng(seed + 61)
    (root / "raw" / "wavs").mkdir(parents=True, exist_ok=True)
    out, rows = [], []
    for i in range(CLASSIC_CLIPS):
        uid = f"LJ{i // 10:03d}-{i:04d}"
        x = synth_audio(rng, float(rng.uniform(*CLASSIC_SECONDS)))
        save_wav(root / "raw" / "wavs" / f"{uid}.wav", x, SR)
        text = " ".join(rng.choice(TTS_WORDS, int(rng.integers(7, 12)))).capitalize() + "."
        rows.append(f"{uid}|{text}|{text}")
        out.append((uid, text, len(x)))
    (root / "raw" / "metadata.csv").write_text("\n".join(rows) + "\n")
    return out


def classic_textgrids(directory, clips: list, seed: int) -> None:
    """A long-format Praat TextGrid (what MFA writes) per clip: the char
    G2P's symbols of its text (a space as ``sp``), the clip's hop frames
    split over them at seeded cuts, so the durations sum to its frames."""
    from amphion_tpu_torch.text.g2p import G2PModule

    g2p = G2PModule("char")
    rng = np.random.default_rng(seed + 62)
    directory.mkdir(parents=True, exist_ok=True)
    for uid, text, samples in clips:
        phones = ["sp" if p == " " else p for p in g2p.phonemes(text)]
        frames = samples // HOP
        cuts = np.sort(rng.choice(np.arange(1, frames), len(phones) - 1, replace=False))
        edges = np.concatenate([[0], cuts, [frames]]) * HOP / SR
        lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "", "xmin = 0 ",
                 f"xmax = {edges[-1]} ", "tiers? <exists> ", "size = 1 ", "item []: ",
                 "    item [1]:", '        class = "IntervalTier" ', '        name = "phones" ',
                 "        xmin = 0 ", f"        xmax = {edges[-1]} ",
                 f"        intervals: size = {len(phones)} "]
        for j, p in enumerate(phones):
            lines += [f"        intervals [{j + 1}]:", f"            xmin = {edges[j]} ",
                      f"            xmax = {edges[j + 1]} ", f'            text = "{p}" ']
        (directory / f"{uid}.TextGrid").write_text("\n".join(lines) + "\n")


def classic_config(root, name: str, run: str, **train) -> str:
    """The recipe of ``name`` at its published widths and batch over the
    corpus, a checkpoint at every saving step (``save_checkpoint_stride``
    [1]: the recipes' [5] and [10] are epoch strides), a log dir and a
    metrics file under ``root``."""
    cfg = {"base_config": os.path.abspath(CLASSIC_MODELS[name]), "dataset": ["ljspeech"],
           "dataset_path": {"ljspeech": str(root / "raw")}, "log_dir": str(root / "ckpts"),
           "preprocess": {"processed_dir": str(root / name / "processed")},
           "train": {"log_interval": 1, "metrics_path": str(root / f"{name}_{run}.jsonl"),
                     "save_checkpoint_stride": [1], "keep_last": [-1], **train}}
    path = root / f"{name}_{run}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def classic_preprocess(root, name: str, clips: list, kernels: dict, seed: int) -> dict:
    """`bins/tts/preprocess.py` with the recipe's switches (VITS: phones;
    FastSpeech2: mels, F0, energy, phones) and, for FastSpeech2, the
    TextGrids MFA would write; launches: kernel 3 once an acoustic batch
    (FastSpeech2), none for VITS."""
    import inspect

    from amphion_tpu_torch.bins.tts import preprocess as pre
    from amphion_tpu_torch.data.processors.acoustic import extract_acoustic_features
    from amphion_tpu_torch.data.samplers import LengthBucketSampler

    for k in kernels.values():
        k.reset()
    t0 = time.perf_counter()
    pre.main(["--config", classic_config(root, name, "pre"), "--device", DEV])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {n: k.launches for n, k in kernels.items()}
    want = {n: 0 for n in kernels}
    d = root / name / "processed" / "ljspeech"
    if name == "fs2":
        budget = inspect.signature(extract_acoustic_features).parameters["max_tokens"].default
        lengths = [max(n // HOP * HOP, HOP) for _, _, n in clips]
        want["mel"] = len(LengthBucketSampler(lengths, max_tokens=budget, shuffle=False))
        classic_textgrids(d / "textgrids", clips, seed)
    files = {sub: len(list((d / sub).glob("*"))) for sub in ("phones", "mels", "f0", "energy")
             if (d / sub).is_dir()}
    check(f"classic preprocess {name}: launches and files",
          got == want and files.get("phones") == CLASSIC_CLIPS and (d / "symbols.dict").is_file()
          and (name == "vits" or files.get("mels") == files.get("f0") == CLASSIC_CLIPS),
          f"launches {got} (predicted {want}); files {files}, {wall:.1f} s")
    return {"wall_s": wall, "launches": got, "files": files}


class MASTimer:
    """While installed, wraps VITS's `maximum_path` in a profiler range
    (``maximum_path``) and, with ``sync``, times each call by the host clock
    between two synchronizes; keeps the first call's lattice."""

    def __init__(self, sync: bool = False):
        from amphion_tpu_torch.models.tts.vits import vits as vits_mod

        self.mod, self.fn, self.sync = vits_mod, vits_mod.maximum_path, sync
        self.ms, self.first = [], None
        vits_mod.maximum_path = self

    def __call__(self, value, mask):
        if self.first is None:
            self.first = (value.clone(), mask.clone())
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function("maximum_path"):
            out = self.fn(value, mask)
        if self.sync:
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def remove(self) -> None:
        self.mod.maximum_path = self.fn


def classic_train(root, name: str, kernels: dict) -> dict:
    """The recipe through `bins/tts/train.main` on the card for
    ``CLASSIC_STEPS`` steps (one epoch) with a checkpoint at
    ``CLASSIC_SAVE``, kernel 3's calls recorded (the first of each shape, at
    both module names: `mel_spectrogram`'s and `LogMelFn`'s); then a resume
    from that checkpoint for the last step, whose losses and weights must
    equal the whole run's (bit-equal, or within 1e-5 relative and 1e-6
    absolute where a CUDA scatter's atomics reorder a sum). Launch counts
    are set to 0 just before each run and read just after: kernel 3
    ``CLASSIC_MEL_PER_STEP`` a step, no other kernel."""
    import shutil

    from amphion_tpu_torch.bins.tts.train import main as train_main
    from amphion_tpu_torch.ops import mel as mel_ops
    from amphion_tpu_torch.ops.kernels import mel as mel_kernel_mod
    from amphion_tpu_torch.runtime.checkpoint import CheckpointManager

    cfg = classic_config(root, name, "run", max_steps=CLASSIC_STEPS,
                         save_checkpoints_steps=CLASSIC_SAVE)
    recs = [CallRecorder(m, "log_mel", first_of_each_shape()) for m in (mel_ops, mel_kernel_mod)]
    for k in kernels.values():
        k.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        trainer = train_main(["--config", cfg, "--exp_name", name, "--device", DEV])
        torch.cuda.synchronize()
    finally:
        for rec in recs:
            rec.remove()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {n: k.launches for n, k in kernels.items()}
    want = {n: 0 for n in kernels}
    want["mel"] = CLASSIC_MEL_PER_STEP[name] * CLASSIC_STEPS
    check(f"classic train {name}: launches", launches == want,
          f"{launches} (predicted {want}: #3 {CLASSIC_MEL_PER_STEP[name]} a step x "
          f"{CLASSIC_STEPS} steps)")
    rows = metrics(root, f"{name}_run")
    keys = [k for k in rows[0] if k not in ("step", "epoch", "step_s", "sec_per_step")]
    check(f"classic train {name}: losses", len(rows) == CLASSIC_STEPS and all(
        math.isfinite(r[k]) for r in rows for k in keys),
        f"{[{k: round(r[k], 5) for k in keys} for r in rows]}")
    secs = [r["step_s"] for r in rows]
    model = trainer.loop.states["g"].model if name == "vits" else trainer.loop.states.model
    perf = {"params": sum(p.numel() for p in model.parameters()), "step_s": secs,
            "median_step_s": statistics.median(secs[1:]), "max_memory_allocated_gib": peak,
            "launches_per_step": launches["mel"] / CLASSIC_STEPS, "run_wall_s": wall}
    if name == "vits":
        d = trainer.loop.states["d"].model
        perf["params_d"] = sum(p.numel() for p in d.parameters())
    log(f"classic train {name} perf ({nvidia_smi()}): {perf['params'] / 1e6:.2f} M params, "
        f"float32, median step {perf['median_step_s']:.4f} s over steps 2-{CLASSIC_STEPS}, "
        f"peak {peak:.2f} GiB; " + json.dumps(perf))
    mel_calls = [c for rec in recs for c in rec.calls]
    ckdir = root / "ckpts" / name / "checkpoint"
    start = next(p for p in ckdir.glob("epoch-*") if f"_step-{CLASSIC_SAVE:07d}_" in p.name)
    cfg2 = classic_config(root, name, "resume", max_steps=CLASSIC_STEPS,
                          save_checkpoints_steps=0)
    for k in kernels.values():
        k.reset()
    again = train_main(["--config", cfg2, "--exp_name", f"{name}_resume", "--resume",
                        "--resume_from_ckpt_path", str(start), "--device", DEV])
    torch.cuda.synchronize()
    got = {n: k.launches for n, k in kernels.items()}
    want["mel"] = CLASSIC_MEL_PER_STEP[name] * (CLASSIC_STEPS - CLASSIC_SAVE)
    rerun = metrics(root, f"{name}_resume")
    first = rows[CLASSIC_SAVE:]
    loss_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                   for a, b in zip(rerun, first) for k in keys)
    del again
    gc.collect()
    states = [CheckpointManager(root / "ckpts" / n / "checkpoint").restore_raw(
        map_location="cpu")[0] for n in (name, f"{name}_resume")]
    if name == "vits":
        a, b = ({**{f"g.{k}": v for k, v in s["g"]["model"].items()},
                 **{f"d.{k}": v for k, v in s["d"]["model"].items()}} for s in states)
    else:
        a, b = states[0]["model"], states[1]["model"]
    w_err = max((a[k] - b[k]).abs().max().item() for k in a)
    bit = loss_rel == 0.0 and w_err == 0.0
    check(f"classic train {name}: resume", len(rerun) == CLASSIC_STEPS - CLASSIC_SAVE
          and got == want and a.keys() == b.keys() and loss_rel <= 1e-5 and w_err <= 1e-6,
          f"step {CLASSIC_STEPS} from the step-{CLASSIC_SAVE} checkpoint: losses max rel diff "
          f"{loss_rel:.3g} (tol 1e-5), weights max|diff| {w_err:.3g} (tol 1e-6), bit-equal "
          f"{bit}; launches {got} (predicted {want})")
    del states, a, b
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root / "ckpts" / f"{name}_resume", ignore_errors=True)
    shutil.rmtree(start, ignore_errors=True)
    return {"trainer": trainer, "perf": perf, "launches": launches, "mel_calls": mel_calls,
            "resume": {"loss_max_rel_diff": loss_rel, "weights_max_abs_diff": w_err,
                       "bit_equal": bit}}


def classic_mel_checks(name: str, calls: list) -> dict:
    """Kernel 3 on the training runs' own inputs (the first call of each
    shape): within 1e-3 of `log_mel_ref` and bit-equal on a relaunch (the
    MaskGCT phase's rule)."""
    from amphion_tpu_torch.ops.kernels.mel import log_mel, log_mel_ref

    bad, worst, shapes = [], 0.0, []
    for i, (y, fb, n_fft, hop, win, clip) in calls:
        got = log_mel(y, fb, n_fft, hop, win, clip)
        err = (got - log_mel_ref(y, fb, n_fft, hop, win, clip)).abs().max().item()
        again = torch.equal(log_mel(y, fb, n_fft, hop, win, clip), got)
        worst = max(worst, err)
        shapes.append(tuple(y.shape))
        if not (err <= 1e-3 and again):
            bad.append((i, tuple(y.shape), err, again))
    check(f"classic {name} #3: the training run's calls against log_mel_ref (tol 1e-3), "
          "relaunched",
          bool(calls) and not bad, f"shapes {shapes}, max|err| {worst:.3g}; failing (call, "
          f"shape, err, relaunch bit-equal): {bad}")
    return {"max_abs_err": worst, "shapes": shapes}


def classic_mel_timing(y: torch.Tensor, mel_cfg, grad: bool) -> dict:
    """Kernel 3 at a training shape by CUDA-graph replays beside its plain
    version and the `torch.stft` chain (`library_mel`); with ``grad`` also
    `LogMelFn`'s backward (autograd of `log_mel_ref`, no kernel). Bound: the
    larger of the row's least operations (`mel_work`) at 67 TFLOP/s and the
    samples read and log-mel written once at 3.35 TB/s."""
    from amphion_tpu_torch.ops.mel import _fbank, mel_spectrogram, mel_spectrogram_ref

    b, t = y.shape
    fb = _fbank(mel_cfg, y.device)
    flops_row, _, _ = mel_work([t], fb)
    with torch.no_grad():
        ms = graph_ms(lambda: mel_spectrogram(y, mel_cfg))
        plain = graph_ms(lambda: mel_spectrogram_ref(y, mel_cfg), iters=5)
        lib = graph_ms(lambda: library_mel(y, fb, mel_cfg.clip_val))
    ops, nbytes = b * flops_row, 4.0 * (b * t + b * fb.shape[0] * (t // mel_cfg.hop_size))
    out = {"shape": [b, t], "ms": ms, "plain_ms": plain, "library_ms": lib,
           "bound_ms": max(ops / PEAK_F32, nbytes / HBM) * 1e3,
           "bound_by": "operations" if ops / PEAK_F32 >= nbytes / HBM else "bytes"}
    if grad:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            leaf = y.clone().requires_grad_()
            mel = mel_spectrogram(leaf, mel_cfg)
            g = torch.randn_like(mel)
        torch.cuda.current_stream().wait_stream(side)
        grad = lambda: torch.autograd.grad(mel, leaf, g, retain_graph=True)  # noqa: E731
        try:
            out["backward_ms"], how = graph_ms(grad, iters=10, stream=side), "graph replays"
        except Exception as exc:  # noqa: BLE001 - the profiler measures it instead
            log(f"  backward capture failed ({type(exc).__name__}: {exc}); profiler time")
            torch.cuda.synchronize()
            out["backward_ms"], how = profiled_ms(grad), "profiler"
        out["backward_is"] = f"LogMelFn.backward: autograd of log_mel_ref, no kernel ({how})"
    return out


def classic_card_vs_cpu(name: str, trainer, seed: int) -> dict:
    """One step at the recipe's width on ``CLASSIC_ROWS`` rows of the
    trainer's first batch, on the CPU and on the card from the same weights
    (the trained ones), batch and draws: every loss within 1e-3 relative.
    For VITS also the alignment of `VITS.train_forward`: where the card's
    differs from the CPU's (the lattice's float32 sums round otherwise, and
    a near-tie flips a frame; `maximum_path` itself is held equal on one
    lattice in `classic_profile`), the differing frames and the lattices'
    difference are printed, and the duration loss, which follows the
    alignment, is held instead on the same durations (the CPU's) through
    the duration predictor on both devices."""
    import copy

    from amphion_tpu_torch.models.tts.vits.vits_trainer import (
        create_vits_states, make_vits_train_step, vits_draws)
    from amphion_tpu_torch.runtime.train_state import TrainState
    from amphion_tpu_torch.runtime.optimizers import ClipAdamW

    utts = trainer._epoch_utts(0)[0][:CLASSIC_ROWS]
    batch = trainer.make_batch(utts)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    res, attn, lattice, sdp = {}, {}, {}, {}
    if name == "vits":
        g0, d0 = (s.model for s in (trainer.loop.states["g"], trainer.loop.states["d"]))
        draws = vits_draws(g0, cpu_batch, torch.Generator().manual_seed(seed + 63))
        for dev, b in (("cpu", cpu_batch), ("card", batch)):
            device = next(iter(b.values())).device
            g, d = copy.deepcopy(g0).to(device), copy.deepcopy(d0).to(device)
            dr = {k: v.to(device) for k, v in draws.items()}
            mas = MASTimer()
            try:
                with torch.no_grad():
                    attn[dev] = g.train_forward(b["phones"], b["phone_mask"], b["spec"],
                                                b["spec_mask"], b["sid"], **dr)["attn"].cpu()
            finally:
                mas.remove()
            lattice[dev] = (mas.first[0] * mas.first[1]).cpu()
            with torch.no_grad():  # the duration loss on the CPU's durations
                x, _, _ = g.text_encoder(b["phones"], b["phone_mask"])
                nll = g.duration_predictor(x, b["phone_mask"], w=attn["cpu"].sum(-1).to(device),
                                           e_q=dr["e_q"])
                sdp[dev] = torch.mean(nll / b["phone_mask"].sum(-1).clamp(min=1.0)).item()
            gs, ds = create_vits_states(g, d, trainer.train_cfg, seed)
            _, _, met = make_vits_train_step(trainer.mel_cfg, trainer.train_cfg)(gs, ds, b, dr)
            res[dev] = {k: v.item() for k, v in met.items()}
            del g, d, gs, ds
    else:
        m0 = trainer.loop.states.model
        for dev, b in (("cpu", cpu_batch), ("card", batch)):
            device = next(iter(b.values())).device
            m = copy.deepcopy(m0).to(device)
            state = TrainState(0, m, ClipAdamW(m.parameters(), 1e-3, max_norm=None),
                               torch.Generator(device))
            _, met = trainer.step(state, b)
            res[dev] = {k: v.item() for k, v in met.items()}
            del m, state
    rel = {k: abs(res["card"][k] - res["cpu"][k]) / max(abs(res["cpu"][k]), 1e-12)
           for k in res["cpu"]}
    extra, frames_differ, gate = "", 0, dict(rel)
    out = {"losses": res, "max_rel": max(rel.values())}
    if attn:
        frames_differ = int((attn["card"] != attn["cpu"]).any(dim=1).sum())
        lat_rel = ((lattice["card"] - lattice["cpu"]).abs().max()
                   / lattice["cpu"].abs().max()).item()
        sdp_rel = abs(sdp["card"] - sdp["cpu"]) / abs(sdp["cpu"])
        if frames_differ:
            gate["g_dur"] = sdp_rel
        out.update(alignment_frames_differ=frames_differ, lattice_max_rel_diff=lat_rel,
                   dur_loss_same_durations={**sdp, "rel": sdp_rel})
        extra = (f"; alignment: {frames_differ} of {int(cpu_batch['spec_mask'].sum())} frames "
                 f"align to another phone on the card (the lattices differ by {lat_rel:.2g} of "
                 f"max|lattice|); the duration loss on the CPU's durations card {sdp['card']:.6f}"
                 f" vs CPU {sdp['cpu']:.6f} (rel {sdp_rel:.2g}), held in place of g_dur where "
                 "the alignments differ")
    check(f"classic {name}: a full-width step on {CLASSIC_ROWS} rows, card vs CPU",
          max(gate.values()) <= 1e-3,
          f"losses card {res['card']} vs CPU {res['cpu']}, max rel {max(rel.values()):.3g}, "
          f"held {max(gate.values()):.3g} (tol 1e-3){extra}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def classic_profile(name: str, trainer) -> dict:
    """One step of the trainer on its first batch under torch.profiler
    (host and device): wall, device busy share (the union of the device
    records over the wall), the top kernels, and for VITS the alignment's
    share: its range's host time over the step's wall (the search is a
    loop of small launches, so its host time is its wall) and the device
    time of the kernels it launched; then three steps with the alignment
    timed between synchronizes."""
    from torch.profiler import ProfilerActivity, profile

    utts = trainer._epoch_utts(0)[0]
    batch = trainer.make_batch(utts)
    states = trainer.loop.states
    mas = MASTimer() if name == "vits" else None
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            states, _ = trainer.loop.train_step(states, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        if mas is not None:
            mas.remove()
    host_names = {e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU}
    spans, seen = [], set()
    for e in prof.profiler.kineto_results.events():
        key = (e.name(), e.start_ns(), e.duration_ns())
        if (e.device_type() == torch.autograd.DeviceType.CUDA and e.name() not in host_names
                and key not in seen):
            seen.add(key)
            spans.append(key)
    union_ns, end = 0, -1
    for _, start, dur in sorted(spans, key=lambda x: x[1]):
        if start + dur > end:
            union_ns += start + dur - max(start, end)
            end = start + dur
    by_name = {}
    for nm, _, dur in spans:
        by_name[nm] = by_name.get(nm, 0.0) + dur / 1e6
    top = sorted(((ms, nm[:80]) for nm, ms in by_name.items()), reverse=True)[:8]
    out = {"wall_s": wall, "device_busy_s": union_ns / 1e9,
           "device_busy_share": union_ns / 1e9 / wall, "device_records": len(spans),
           "top_kernels_ms": [[nm, ms] for ms, nm in top]}
    if mas is not None:
        rng = [e for e in prof.key_averages() if e.key == "maximum_path"]
        host_ms = rng[0].cpu_time_total / 1e3 if rng else float("nan")
        dev_ms = rng[0].device_time_total / 1e3 if rng else float("nan")
        out["alignment"] = {"range_host_ms": host_ms, "range_device_ms": dev_ms,
                            "share_of_profiled_step": host_ms / 1e3 / wall}
        timer = MASTimer(sync=True)
        try:
            t0 = time.perf_counter()
            for _ in range(3):
                states, _ = trainer.loop.train_step(states, batch)
            torch.cuda.synchronize()
            steps_s = (time.perf_counter() - t0) / 3
        finally:
            timer.remove()
        value, mask = timer.first
        from amphion_tpu_torch.ops.mas import maximum_path

        same = torch.equal(maximum_path(value, mask).cpu(),
                           maximum_path(value.cpu(), mask.cpu()))
        out["alignment"].update({
            "synced_ms": timer.ms, "synced_step_s": steps_s,
            "share_of_synced_step": statistics.median(timer.ms) / 1e3 / steps_s,
            "lattice": list(value.shape), "card_equals_cpu": same})
        check("classic vits: maximum_path on the card equals the CPU's on the step's lattice",
              same, f"lattice {tuple(value.shape)}; synced search {statistics.median(timer.ms):.2f} "
              f"ms of a {steps_s * 1e3:.1f} ms step")
    check(f"classic {name} trace", union_ns > 0 and bool(top),
          f"device busy {union_ns / 1e9:.4g} s of {wall:.4g} s; top {top[:3]}")
    return out


def classic_cli(root, name: str, extra: list, label: str) -> dict:
    """`bins/tts/inference.py` from the trained checkpoint: a finite 24 kHz
    wav whose length is the model's frame mask × hop (Griffin-Lim: frames −
    1)."""
    from amphion_tpu_torch.bins.tts import inference as tts_cli_mod
    from amphion_tpu_torch.data.audio_io import load_wav

    out = str(root / f"{label}.wav")
    t0 = time.perf_counter()
    info = tts_cli_mod.main(["--config", classic_config(root, name, "cli"), "--exp_name", name,
                             "--text", CLASSIC_TEXT, "--output_path", out, "--device", DEV,
                             *extra])
    wall = time.perf_counter() - t0
    wav, sr = load_wav(out)
    gl = name == "fs2" and not extra
    want = (info["frames"] - (1 if gl else 0)) * HOP
    check(f"classic {label} CLI from the trained checkpoint (bins/tts/inference.py)",
          sr == SR and info["frames"] >= 2 and len(wav) == want == info["samples"]
          and bool(np.isfinite(wav).all()),
          f"{len(wav)} samples at {sr} Hz, the frame mask {info['frames']} frames (want "
          f"{want} samples), max|x| {float(np.abs(wav).max()):.3g}, {wall:.1f} s")
    return {"wall_s": wall, "frames": info["frames"], "samples": len(wav)}


def classic_vocoder(root, seed: int) -> str:
    """A HiFi-GAN checkpoint at ``egs/vocoder/gan/hifigan``'s width (80
    mels, hop 120) from random weights, with its config beside it, as
    `bins/tts/inference.py --vocoder_ckpt` reads it."""
    from amphion_tpu_torch.runtime.vocoder_trainer import build_generator, save_generator
    from amphion_tpu_torch.utils.config import load_config, save_config
    from amphion_tpu_torch.utils.convert import init_like_flax

    cfg = load_config("egs/vocoder/gan/hifigan/exp_config.json")
    gen, hop = build_generator(cfg, cfg["preprocess"]["n_mel"])
    assert hop == HOP
    init_like_flax(gen.to(DEV), torch.Generator(DEV).manual_seed(seed + 64))
    save_generator(root / "hifigan" / "checkpoint", gen)
    save_config(root / "hifigan" / "exp_config.json", cfg)
    return str(root / "hifigan" / "checkpoint")


def classic_tts_phase(seed: int, kernels: dict, rows: list) -> dict:
    """VITS and FastSpeech2 as the LJSpeech recipes run them
    (egs/tts/{VITS,FastSpeech2}): a synthetic LJSpeech corpus with MFA-style
    TextGrids, `bins/tts/preprocess.py`, `bins/tts/train.py` at the
    recipes' widths and batch (VITS 192 x 6 text encoder, 16-layer
    posterior, 4 flows, SDP, HiFi-GAN 512 against MPD + MSD, segments of 32
    frames; FastSpeech2 256 x (4 + 6) FFT blocks) in float32 for 3 steps
    and a resume, the steps card vs CPU, a profiled step of each with the
    alignment's share, `bins/tts/inference.py` (VITS; FastSpeech2 with
    Griffin-Lim and with a HiFi-GAN checkpoint), and kernel 3 on the runs'
    own inputs and timed at their shapes, whose rows join ``rows``."""
    import shutil
    import tempfile
    from pathlib import Path

    laps, t0 = {}, time.perf_counter()

    def lap(key: str) -> None:
        nonlocal t0
        laps[key] = laps.get(key, 0.0) + time.perf_counter() - t0
        t0 = time.perf_counter()

    old_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # cuDNN's weight gradients sum in order
    root = Path(tempfile.mkdtemp(prefix="classic_"))
    out = {}
    try:
        clips = classic_corpus(root, seed)
        voc = classic_vocoder(root, seed)
        lap("corpus")
        for name in CLASSIC_MODELS:
            pre = classic_preprocess(root, name, clips, kernels, seed)
            lap(f"{name}_preprocess")
            run = classic_train(root, name, kernels)
            lap(f"{name}_train_and_resume")
            trainer = run.pop("trainer")
            vs_cpu = classic_card_vs_cpu(name, trainer, seed)
            lap(f"{name}_card_vs_cpu")
            prof = classic_profile(name, trainer)
            lap(f"{name}_profile")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            cli = {name: classic_cli(root, name, [], name)}
            if name == "fs2":
                cli["fs2_gl"] = cli.pop("fs2")
                cli["fs2_hifigan"] = classic_cli(root, name, ["--vocoder_ckpt", voc],
                                                 "fs2_hifigan")
            lap(f"{name}_cli")
            out[name] = {"preprocess": pre, **run, "card_vs_cpu": vs_cpu, "profile": prof,
                         "cli": cli}
        errs = {n: classic_mel_checks(n, out[n]["mel_calls"]) for n in CLASSIC_MODELS}
        calls = out["vits"]["mel_calls"] + out["fs2"]["mel_calls"]
        from amphion_tpu_torch.ops.mel import MelConfig
        from amphion_tpu_torch.utils.config import load_config

        mel_cfg = MelConfig.from_preprocess_cfg(load_config(CLASSIC_MODELS["fs2"])["preprocess"])
        by_shape = {}
        for _, (y, *_) in calls:
            by_shape.setdefault(tuple(y.shape), y)
        timing = {}
        for name, grad in (("vits", True), ("fs2", False)):
            shape = max((s for s in by_shape if (s[1] > 10000) == (name == "fs2")),
                        key=lambda s: s[1])
            timing[name] = classic_mel_timing(by_shape[shape], mel_cfg, grad)
            t = timing[name]
            log(f"timing classic #3 {name} {shape} ({nvidia_smi()}): kernel {t['ms']:.5f} ms, "
                f"plain {t['plain_ms']:.5f}, torch.stft chain {t['library_ms']:.5f}, bound "
                f"{t['bound_ms']:.5f} ({t['bound_by']})"
                + (f"; LogMelFn backward {t['backward_ms']:.5f} ms" if grad else ""))
        lap("mel_checks_and_timing")
        for name, label in (("vits", "VITS mel loss: the real segments forward and the "
                                     "generated ones through LogMelFn, a step"),
                            ("fs2", "FastSpeech2's batch mels, a step")):
            t, o = timing[name], out[name]
            rows.append(_row(f"mel_spectrogram_{name}_training", "mel.cu", 425,
                             o["launches"]["mel"], errs[name]["max_abs_err"], t["ms"],
                             t["plain_ms"],
                             t["bound_ms"], t["bound_by"], t["library_ms"],
                             shape=f"{tuple(t['shape'])} f32", launches_are=(
                                 f"the {CLASSIC_STEPS}-step run at the recipe's batch ({label}), "
                                 "counted at the wrapper"),
                             launches_per_step=o["perf"]["launches_per_step"],
                             recorded_shapes=errs[name]["shapes"],
                             **({"backward": {k: t[k] for k in ("backward_ms", "backward_is")}}
                                if name == "vits" else {}),
                             timing="CUDA-graph replays on a recorded training input"))
    finally:
        torch.backends.cudnn.deterministic = old_det
        shutil.rmtree(root, ignore_errors=True)
    log("classic tts laps (s): " + json.dumps(laps))
    log(f"classic tts ({nvidia_smi()}): " + json.dumps(
        {n: {k: o[k] for k in ("perf", "preprocess", "resume", "card_vs_cpu", "profile", "cli")}
         for n, o in out.items()}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-new", type=int, default=192,
                    help="AR decode steps of the voice runs (bins/serve.py's default is "
                         "768; cut so that the whole run stays well inside its time)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(1100)  # where a run that outlives its limit stands
    t_start = time.perf_counter()
    from amphion_tpu_torch.ops import mel as mel_mod
    from amphion_tpu_torch.ops.kernels import _build
    from amphion_tpu_torch.ops.kernels.aa_snake import AA_SNAKE
    from amphion_tpu_torch.ops.kernels.bf16_gemv import BF16_GEMV
    from amphion_tpu_torch.ops.kernels import flash_attention as flash_mod
    from amphion_tpu_torch.ops.kernels.decode_attention import DECODE_ATTN
    from amphion_tpu_torch.ops.kernels.flash_attention import FLASH, FLASH_BWD
    from amphion_tpu_torch.ops.kernels.int4_matmul import INT4_MM
    from amphion_tpu_torch.ops.kernels.int8_matmul import INT8_MM
    from amphion_tpu_torch.ops.kernels.mel import MEL
    from amphion_tpu_torch.ops.kernels.rms_norm import RMS_NORM
    from amphion_tpu_torch.ops.kernels.snake import SNAKE
    from amphion_tpu_torch.utils.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip().splitlines()[-1]
    card = nvidia_smi()
    log(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, nvcc {nvcc!r}, card {card!r}")
    kernels = {"mel": MEL, "flash_attn_fwd": FLASH, "flash_attn_bwd": FLASH_BWD,
               "int8_matmul": INT8_MM, "int4_matmul": INT4_MM,
               "decode_attn_int8": DECODE_ATTN, "snake": SNAKE, "aa_snake": AA_SNAKE,
               "rms_norm": RMS_NORM, "bf16_gemv": BF16_GEMV}
    t0 = time.perf_counter()
    _build.build_all(list(kernels.values()))
    log(f"build: {', '.join(k.source.name for k in kernels.values())} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")

    laps = [time.perf_counter()]

    def lap(name: str) -> None:
        """Logs the seconds since the last lap: where the run's time goes."""
        laps.append(time.perf_counter())
        log(f"{name} phases {laps[-1] - laps[-2]:.1f} s")

    errs = kernel_phase(mel_mod, flash_mod, args.seed)
    errs.update(bwd_kernel_phase(flash_mod, args.seed))
    quant_kernel_phase(args.seed)
    errs.update(snake_kernel_phase(args.seed))
    lap("kernel check")
    vocoder_reference_phase(args.seed)
    reference_phase(args.seed)
    ar_reference_phase(args.seed)
    train_reference_phase(args.seed)
    train = {stage: train_phase(stage, args.seed, kernels) for stage in TRAIN}
    lap("reference and training")
    sl = slice_phase(args.seed, MEL, FLASH)
    rows = timing_phase(mel_mod, flash_mod, sl, errs)
    cfg = load_config("config/vevo.json")
    v8 = voice_phase(cfg, args.seed, "int8", None, args.max_new, kernels, solo_check=True)
    v4 = voice_phase(cfg, args.seed, "int4", v8["audio"], args.max_new, kernels,
                     solo_check=False)
    fused = fused_phase(v8, v4, args.seed, args.max_new, kernels)
    padding_phase(v8)
    lap("timbre and voice")
    for v, dtype in ((v8, "int8"), (v4, "int4")):
        row_invariance_phase(v, dtype, args.max_new)
        engine_phase(v, dtype, ENGINE_MAX_NEW, kernels)["svc"].shutdown()
    bf16_engine_phase(cfg, args.seed, v8, args.max_new)
    lap("voice engine")
    http = http_phase(cfg, args.seed, "int8", args.max_new, kernels, v8["audio"])
    lap("voice http")
    rows += quant_timing_phase(v8, v4, fused)
    rows += engine_kernel_rows(v8, http)
    del v8, v4, fused
    gc.collect()
    torch.cuda.empty_cache()
    bwd_row, fwd_extra = bwd_timing_phase(flash_mod, train, errs)
    next(r for r in rows if r["name"] == "flash_attn_fwd").update(fwd_extra)
    rows.append(bwd_row)
    lap("kernel timing")
    voc = vocoder_phase(args.seed, kernels)
    rows += snake_timing_phase(voc, errs, kernels)
    del voc
    gc.collect()
    torch.cuda.empty_cache()
    lap("vocoder")
    gan_phase(args.seed, kernels, rows)
    gc.collect()
    torch.cuda.empty_cache()
    lap("gan training")
    zoo_phase(args.seed, kernels, rows)
    gc.collect()
    torch.cuda.empty_cache()
    lap("gan vocoder zoo")
    maskgct_reference_phase(args.seed)
    mg = maskgct_phase(args.seed, kernels)
    for r in rows:  # kernel 1's first model path
        if r["name"] == "snake":
            r["maskgct_path_launches"] = mg["launches"]["snake"]
    rows += mg["rows"]
    del mg
    gc.collect()
    torch.cuda.empty_cache()
    lap("maskgct")
    valle_reference_phase(args.seed)
    rows += valle_phase(args.seed, kernels, VALLE_MAX_NEW)["rows"]
    lap("valle")
    tts_training_phase(args.seed, kernels, rows)
    lap("tts training")
    classic_tts_phase(args.seed, kernels, rows)
    lap("classic tts")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
