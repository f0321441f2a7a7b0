#!/usr/bin/env python3
"""Drive the PyTorch port (`amphion_tpu_torch`) on one CUDA card.

Builds the eight CUDA kernels from ``amphion_tpu_torch/ops/kernels/csrc``
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
  ``--max-new`` steps through the int8/int4 matmul kernels and the int8 KV
  cache, then flow matching through the same kernels);
- one single-utterance int8 Vevo-Voice run with the fused decode-attention
  kernel (``AMPHION_FUSED_DECODE_ATTN=1``) and an int4 decode with the
  fused RMSNorm prologue (``AMPHION_FUSED_RMS=1``);
- BigVGAN copy synthesis at the width of
  ``egs/vocoder/gan/bigvgan/exp_config.json`` through
  `amphion_tpu_torch.bins.vocoder.inference.main` on six files of 2-10 s
  (mel kernel, anti-aliased SnakeBeta kernel in all 73 activations), a
  small generator on the card against the CPU, and Snake's kernel driven
  through ``Snake(use_pallas=True)`` (no model path runs it);

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
measures what padding each voice decode to ``max_batch`` rows costs and
which PyTorch operations make the padding necessary, times each kernel at
the shapes the paths gave it (by CUDA-graph replays, beside SDPA timed the
same way for the flash kernels), and profiles one voice batch, two steps of
each trainer and one 10 s copy synthesis. Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--max-new 768]

Exits nonzero on any failure, and at once when there is no CUDA card. The
last three lines of standard output are the ``{"kernels": [...]}`` timing
line, then the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``) on the line before
the last, then ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import argparse
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


def graph_node_types(fn) -> list:
    """The node types (CUgraphNodeType: 0 a kernel) of the CUDA graph that
    one ``fn()`` captures, read by the driver's cuGraphGetNodes."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
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
        trace = None
        if dtype == "int8":
            t0 = time.perf_counter()
            trace = profile_rerun(svc, audio, seeds, "voice")
            log(f"voice {dtype} trace (profiled rerun, {time.perf_counter() - t0:.1f} s with "
                "the profiler's processing): " + json.dumps(trace))
    finally:
        svc.shutdown()
        service_mod.ar_transformer_generate_ragged = rec.inner
    return {"pipe": pipe, "audio": audio, "launches": launches, "gemm_launches": gemm_launches,
            "perf": perf,
            "shapes": shapes, "trace": trace, "path_err": path_err, "seeds": seeds,
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
    whose result or inputs do not lead with the batch. The port's own CUDA
    kernels run outside PyTorch's dispatcher and are not seen here."""

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
                or not isinstance(out, torch.Tensor) or out.dim() == 0
                or out.shape[0] != self.b):
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
    """What padding every voice decode to the service's ``max_batch`` rows
    costs, and why it is there. Decodes the int8 voice batch's requests
    (row 0 is request 0, rows past the fourth repeat it, as the service
    pads) at each row count of DECODE_ROWS: wall and device time per decode
    step, each the difference of a 72-step and an 8-step decode (the
    prefill cancels), the device time from a profiled rerun; and how many
    of row 0's tokens agree between consecutive row counts. Then one
    prefill and two steps at 4 rows under `RowAloneCheck`: the PyTorch
    operations whose row 0 changes its bits when row 0 runs alone."""
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
    log(f"voice padding: row 0's {s2} tokens equal between row counts: " + json.dumps(agree))
    with RowAloneCheck(4) as mode:
        decode(4, 2)
    log(f"voice padding: {mode.checked} of {mode.ops} PyTorch operations of a prefill and "
        f"two steps at 4 rows rerun on row 0 alone; row 0's bits differ in: "
        + json.dumps(mode.differ))
    return {"cost": cost, "row0_tokens_equal": agree, "differ": mode.differ}


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
               launches_per_step={"fm": FM_LAYERS, "ar": AR_LAYERS},
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-new", type=int, default=768,
                    help="AR decode steps of the voice runs (bins/serve.py's default)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from amphion_tpu_torch.ops import mel as mel_mod
    from amphion_tpu_torch.ops.kernels import _build
    from amphion_tpu_torch.ops.kernels.aa_snake import AA_SNAKE
    from amphion_tpu_torch.ops.kernels import flash_attention as flash_mod
    from amphion_tpu_torch.ops.kernels.decode_attention import DECODE_ATTN
    from amphion_tpu_torch.ops.kernels.flash_attention import FLASH, FLASH_BWD
    from amphion_tpu_torch.ops.kernels.int4_matmul import INT4_MM
    from amphion_tpu_torch.ops.kernels.int8_matmul import INT8_MM
    from amphion_tpu_torch.ops.kernels.mel import MEL
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
               "decode_attn_int8": DECODE_ATTN, "snake": SNAKE, "aa_snake": AA_SNAKE}
    t0 = time.perf_counter()
    _build.build_all(list(kernels.values()))
    log(f"build: {', '.join(k.source.name for k in kernels.values())} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")

    errs = kernel_phase(mel_mod, flash_mod, args.seed)
    errs.update(bwd_kernel_phase(flash_mod, args.seed))
    quant_kernel_phase(args.seed)
    errs.update(snake_kernel_phase(args.seed))
    vocoder_reference_phase(args.seed)
    reference_phase(args.seed)
    ar_reference_phase(args.seed)
    train_reference_phase(args.seed)
    train = {stage: train_phase(stage, args.seed, kernels) for stage in TRAIN}
    sl = slice_phase(args.seed, MEL, FLASH)
    rows = timing_phase(mel_mod, flash_mod, sl, errs)
    cfg = load_config("config/vevo.json")
    v8 = voice_phase(cfg, args.seed, "int8", None, args.max_new, kernels, solo_check=True)
    v4 = voice_phase(cfg, args.seed, "int4", v8["audio"], args.max_new, kernels,
                     solo_check=False)
    fused = fused_phase(v8, v4, args.seed, args.max_new, kernels)
    padding_phase(v8)
    rows += quant_timing_phase(v8, v4, fused)
    del v8, v4, fused
    gc.collect()
    torch.cuda.empty_cache()
    bwd_row, fwd_extra = bwd_timing_phase(flash_mod, train, errs)
    next(r for r in rows if r["name"] == "flash_attn_fwd").update(fwd_extra)
    rows.append(bwd_row)
    voc = vocoder_phase(args.seed, kernels)
    rows += snake_timing_phase(voc, errs, kernels)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
