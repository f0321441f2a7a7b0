#!/usr/bin/env python3
"""Drive the PyTorch port (`amphion_tpu_torch`) on one CUDA card.

Builds the five CUDA kernels from ``amphion_tpu_torch/ops/kernels/csrc``
with nvcc (one process each, in parallel) and holds each against its plain
PyTorch version. Then, at the full width of ``config/vevo.json`` with
random weights from ``--seed``:

- Vevo-Timbre: four concurrent requests (mel and flash-attention kernels);
- Vevo-Voice: four concurrent requests in int8, then in int4 (AR decode of
  ``--max-new`` steps through the int8/int4 matmul kernels and the int8 KV
  cache, then flow matching through the same kernels);
- one single-utterance int8 Vevo-Voice run with the fused decode-attention
  kernel (``AMPHION_FUSED_DECODE_ATTN=1``) and an int4 decode with the
  fused RMSNorm prologue (``AMPHION_FUSED_RMS=1``);

checking outputs, launch counts against counts worked out beforehand and
batch invariance, and holding the int8/int4 matmul kernels against their
plain versions on the inputs the voice paths gave them (decode, AR prefill
and flow-matching rows, with and without the RMSNorm prologue). It then
measures what padding each voice decode to ``max_batch`` rows costs and
which PyTorch operations make the padding necessary, times each kernel at
the shapes the paths gave it and profiles one voice batch. Run from the
repository root:

    python3 chip_smoke.py [--seed 0] [--max-new 768]

Exits nonzero on any failure, and at once when there is no CUDA card. The
second-to-last line of standard output is the card's name and power limit,
the one before it the ``{"kernels": [...]}`` timing line, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
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
PEAK_BF16, PEAK_F32, HBM = 989e12, 67e12, 3.35e12  # H100 SXM data sheet
# (reference seconds, source seconds) of the four requests: one length
# bucket, so the four share one batch of flash-attention shape (4, 1536, 16, 64)
REQUESTS = [(2.0, 4.6), (2.6, 5.5), (3.3, 6.8), (4.0, 8.0)]


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


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` replayed as one CUDA graph (the host's
    launch overhead taken out), by CUDA events after warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return gpu_ms(graph.replay, iters)


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
    from amphion_tpu_torch.ops.mel import MelConfig

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(seed)
    cfg = MelConfig()
    errs = {"mel": 0.0, "flash": 0.0}
    log("kernel mel (f32, tol 1e-3 on log-mel):")
    shapes = [(4, 5 * SR), (2, 119 * HOP + 37)]
    shapes += sorted({(1, grid_len(s)) for pair in REQUESTS for s in pair})
    for b, t in shapes:
        y = torch.randn((b, t), generator=g, device=dev) * 0.2
        out = mel_mod.mel_spectrogram(y, cfg)
        ref = mel_mod.mel_spectrogram_ref(y, cfg)
        err = (out - ref).abs().max().item()
        errs["mel"] = max(errs["mel"], err)
        check(f"mel B={b} T={t}", out.shape == ref.shape and err <= 1e-3,
              f"shape {tuple(out.shape)} max|err| {err:.3g}")
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
            ref = flash_mod.attention_ref(q, k, v, mask, causal)
            name = f"B={b} Lq={lq} Lk={lk} H={h} KVH={kvh} D={d} causal={causal} mask={use_mask}"
            if dtype == torch.bfloat16:
                ok, detail = close_bf16(out, ref)
            else:
                err = (out - ref).abs().max().item()
                ok, detail = err <= 1e-4, f"max|err| {err:.3g} (tol 1e-4)"
            if (b, lq, h, d, dtype) == (4, 1536, 16, 64, torch.bfloat16):
                errs["flash"] = (out.float() - ref.float()).abs().max().item()
            check(name, ok, detail)
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


KERNEL_GROUPS = [("flash_attn_fwd", "flash_fwd"), ("mel", "mel_kernel"),
                 ("int8_matmul", "int8_ge"), ("int4_matmul", "int4_ge"),
                 ("decode_attn_int8", "decode_"), ]
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
        group = next((g for g, pat in KERNEL_GROUPS if pat in name), None)
        if group is None:
            group = "gemm" if any(t in name for t in LIBRARY_GEMM) else "other"
        groups[group] += us
    busy = sum(groups.values()) / 1e6
    top = sorted(((us, n[:80]) for n, us in by_name.items()), reverse=True)
    return {"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_records": n_kernels, "summed_in_s": time.perf_counter() - t0,
            "by_group_s": {k: v / 1e6 for k, v in groups.items()},
            "top_kernels_ms": [[n, us / 1e3] for us, n in top[:8]]}


def timing_phase(mel_mod, flash_mod, sl: dict, errs: dict) -> list:
    from amphion_tpu_torch.ops.mel import MelConfig, _fbank

    dev = torch.device("cuda")
    cfg = MelConfig()
    g = torch.Generator(dev).manual_seed(1)
    ys = [torch.randn((1, t), generator=g, device=dev) * 0.2 for t in sl["mel_lengths"]]
    fb = _fbank(cfg, dev)
    win = F.pad(torch.hann_window(cfg.win_size, device=dev),
                ((N_FFT - cfg.win_size) // 2, (N_FFT - cfg.win_size + 1) // 2))
    pad = (N_FFT - HOP) // 2

    def library_mel(y):  # torch.stft + magnitude + mel matmul + log
        yp = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
        spec = torch.stft(yp, N_FFT, HOP, window=win, center=False, return_complex=True)
        mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6)
        return torch.log(torch.clamp(fb @ mag, min=cfg.clip_val))

    n = len(ys)
    mel_ms = gpu_ms(lambda: [mel_mod.mel_spectrogram(y, cfg) for y in ys]) / n
    mel_plain = gpu_ms(lambda: [mel_mod.mel_spectrogram_ref(y, cfg) for y in ys]) / n
    mel_lib = gpu_ms(lambda: [library_mel(y) for y in ys]) / n
    lib_err = max((library_mel(y) - mel_mod.mel_spectrogram_ref(y, cfg)).abs().max().item()
                  for y in ys)
    frames = sum(y.shape[1] // HOP for y in ys) / n
    samples = sum(y.shape[1] for y in ys) / n
    # least operations per frame: a real-input FFT (complex FFT of n/2 points,
    # 2.5 (n/2) log2(n/2), plus its split pass, about 6 per half-bin), the
    # magnitude (4 per bin) and the mel projection over the filterbank's
    # nonzeros only (2 per nonzero; the Slaney triangles overlap little)
    f, nnz = N_FFT // 2 + 1, int((fb != 0).sum())
    mel_flops = frames * (2.5 * (N_FFT / 2) * math.log2(N_FFT / 2) + 6 * (N_FFT // 2)
                          + 4 * f + 2 * nnz)
    mel_bytes = 4 * (samples + frames * cfg.n_mel)
    mel_bound = max(mel_flops / PEAK_F32, mel_bytes / HBM) * 1e3
    log(f"timing mel_spectrogram: kernel {mel_ms:.5f} ms, plain {mel_plain:.5f} ms, "
        f"library (torch.stft) {mel_lib:.5f} ms (max|diff| {lib_err:.2g}), bound "
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
    fl_ms = gpu_ms(lambda: flash_mod.flash_attention(q, k, v, mask))
    fl_plain = gpu_ms(lambda: flash_mod.attention_ref(q, k, v, mask), iters=5)
    fl_lib = gpu_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bmask))
    fl_flops = 4.0 * h * d * L * float(valid.sum())  # QK^T and PV over valid keys
    fl_bytes = 4 * b * L * h * d * 2 + b * L * 4
    fl_bound = max(fl_flops / PEAK_BF16, fl_bytes / HBM) * 1e3
    log(f"timing flash_attn_fwd: kernel {fl_ms:.5f} ms, plain {fl_plain:.5f} ms, "
        f"library (SDPA) {fl_lib:.5f} ms, bound {fl_bound:.5f} ms at bf16 q/k/v "
        f"({b}, {L}, {h}, {d}), key mask, valid {sl['valid']}")

    return [
        _row("mel_spectrogram", "mel.cu", 425, sl["launches"]["mel"], errs["mel"], mel_ms,
            mel_plain, mel_bound,
            "operations" if mel_flops / PEAK_F32 >= mel_bytes / HBM else "bytes", mel_lib),
        _row("flash_attn_fwd", "flash_attn_fwd.cu", 843, sl["launches"]["flash_attn_fwd"],
            errs["flash"], fl_ms, fl_plain, fl_bound,
            "operations" if fl_flops / PEAK_BF16 >= fl_bytes / HBM else "bytes", fl_lib),
    ]


# -- Vevo-Voice: kernels 4, 5 and 8 ----------------------------------------------

DEV = "cuda"  # the card the smoke drives
AR_LAYERS, AR_HIDDEN, AR_HEADS, AR_FFN = 24, 1280, 20, 4096  # config/vevo.json, FFN 4096
FM_LAYERS, FM_HIDDEN, FM_STEPS = 16, 1024, 32
AR_PROJ = [(AR_HIDDEN, 3 * AR_HIDDEN), (AR_HIDDEN, AR_HIDDEN), (AR_HIDDEN, 2 * AR_FFN),
           (AR_FFN, AR_HIDDEN)]  # (K, N) of qkv, o, gateup, down
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
    At the decode rows (M <= 8) it also reports whether row 0 of the GEMV's
    output keeps its bits when row 0 is sent alone. Returns the largest
    float32 error."""
    from amphion_tpu_torch.ops.kernels.int4_matmul import int4_matmul, int4_matmul_ref
    from amphion_tpu_torch.ops.kernels.int8_matmul import int8_matmul, int8_matmul_ref

    worst, row_inv = 0.0, []
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
        check(f"{label} path {name} M={m} K={k} N={n} rms_prologue={pro}", ok and same,
              f"{detail}; {x.dtype} output equals the float32 one rounded: {same}")
        if m <= 8:
            row_inv.append(bool(torch.equal(run(kernel, x[:1], x.dtype)[0], out_bf[0])))
    if row_inv:
        log(f"  {label} GEMV row 0 alone vs at the decode rows: bit-equal in "
            f"{sum(row_inv)}/{len(row_inv)} projections")
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
        peak = torch.cuda.max_memory_allocated() / 2**30
        prec.remove()
        n_batches = svc.stats()["batches"] - batches0
        log(f"voice {dtype}: launches {launches} over {n_batches} batch(es)")
        check(f"voice {dtype} one batch", n_batches == 1, f"{n_batches} batch(es)")
        want = voice_launches(max_new)
        check(f"voice {dtype} {qk.name} launches", launches[qk.name] == want,
              f"{launches[qk.name]} (predicted {AR_LAYERS}*4 + {max_new}*{AR_LAYERS}*4 + "
              f"{FM_STEPS}*{FM_LAYERS}*4 = {want})")
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
    return {"pipe": pipe, "audio": audio, "launches": launches, "perf": perf,
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
    n_attn, n8 = kernels["decode_attn_int8"].launches, kernels["int8_matmul"].launches
    check("fused decode attention launches", n_attn == AR_LAYERS * max_new,
          f"{n_attn} (predicted {AR_LAYERS} layers x {max_new} steps), int8_matmul {n8} "
          f"(predicted {voice_launches(max_new)})")
    check("fused decode attention output", n8 == voice_launches(max_new)
          and bool(torch.isfinite(wav).all()) and wav.ndim == 1 and len(wav) % HOP == 0,
          f"{len(wav)} samples, finite, single utterance in {wall:.2f} s, cache {cache_len}")

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
    pro = k4.tagged.get("rms_prologue", 0)
    check("fused RMSNorm prologue launches", pro == 2 * AR_LAYERS * (1 + steps)
          and k4.launches == 4 * AR_LAYERS * (1 + steps) and bool((toks >= 0).all()),
          f"{pro} prologue launches of {k4.launches} (predicted 2 x {AR_LAYERS} layers x "
          f"(prefill + {steps} steps) of 4 x ...)")
    pro_rows = sorted({m for _, m, p in prec.seen if p})
    check("fused RMSNorm prologue rows", pro_rows == [len(gens), v4["shapes"]["ar_prefill_rows"]],
          f"{pro_rows} (decode {len(gens)}, the voice batch's AR prefill "
          f"{v4['shapes']['ar_prefill_rows']})")
    pro_err = path_quant_check("int4 fused RMSNorm", prec, True)
    return {"cache_len": cache_len, "prompt_len": cache_len - max_new, "fused_wall_s": wall,
            "attn_launches": n_attn, "prologue_launches": pro, "attn_err": attn_err,
            "prologue_err": pro_err}


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
    int8, more than the L2 holds), bound by their bytes; the ``fm_gemm_*``
    keys time the flow-matching qkv projection at the batch's B * L rows,
    bound by bf16 operations. Decode attention is timed at the
    single-utterance cache with valid_len at its middle step."""
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

        per_shape = {}
        for rows_m in (1, m, 8):
            xm = {k: torch.randn((rows_m, k), generator=g, device=dev).bfloat16()
                  for k in (AR_HIDDEN, AR_FFN)}
            for i, label in enumerate(("qkv", "o", "gateup", "down")):
                sub = mods[i::4]
                k_in = sub[0].kernel_q.shape[1] * (2 if name == "int4_matmul" else 1)
                per_shape[f"M={rows_m} {label}"] = graph_ms(lambda: [
                    mm(xm[k_in], q.kernel_q, q.scale, *extra(q), out_dtype=torch.bfloat16)
                    for q in sub]) / len(sub) * 1e3
        log(f"timing {name}: us per call by projection and rows (CUDA graph, "
            f"{len(mods) // 4} layers' weights each): " + json.dumps(per_shape))
        eager_ms = gpu_ms(lambda: [call(mm, q) for q in mods])
        k_ms = graph_ms(lambda: [call(mm, q) for q in mods])
        p_ms = graph_ms(lambda: [call(ref, q) for q in mods], iters=5)
        nbytes = sum(q.kernel_q.numel() + 4 * q.scale.numel() for q in mods)
        nbytes += sum(2 * m * (q.kernel_q.shape[1] * (2 if name == "int4_matmul" else 1)
                               + q.kernel_q.shape[0]) for q in mods)
        ops = sum(2.0 * m * q.kernel_q.shape[0] * q.kernel_q.shape[1]
                  * (2 if name == "int4_matmul" else 1) for q in mods)
        bound, by = _bound(ops, nbytes)
        lib = library(name, mods, lambda q: xs[q.kernel_q.shape[1] * (2 if name == "int4_matmul" else 1)])
        # the flow-matching qkv projection at the batch's rows
        fm = v["pipe"].fm.diff_estimator.encoder.layer_0.attn.qkv_proj
        rows_fm = v["shapes"]["fm_rows"]
        xf = torch.randn((rows_fm, FM_HIDDEN), generator=g, device=dev).bfloat16()
        fm_ms = gpu_ms(lambda: mm(xf, fm.kernel_q, fm.scale, *extra(fm), out_dtype=torch.bfloat16))
        fm_plain = gpu_ms(lambda: ref(xf, fm.kernel_q, fm.scale, *extra(fm),
                                      out_dtype=torch.bfloat16), iters=3)
        n_fm = fm.kernel_q.shape[0]
        fm_bound, fm_by = _bound(2.0 * rows_fm * FM_HIDDEN * n_fm,
                                 fm.kernel_q.numel() + 4 * fm.scale.numel()
                                 + 2 * rows_fm * (FM_HIDDEN + n_fm))
        fm_lib = library(name, [fm], lambda q: xf)
        log(f"timing {name}: one decode step ({len(mods)} projections, M={m}, "
            f"{nbytes / 1e6:.1f} MB, device time of a CUDA-graph replay) kernel {k_ms} ms "
            f"({eager_ms} ms launched one by one from Python), plain {p_ms} ms, library {lib} ms, "
            f"bound {bound} ms ({by}); FM qkv ({rows_fm}, {FM_HIDDEN}) -> {n_fm}: kernel "
            f"{fm_ms} ms, plain {fm_plain} ms, library {fm_lib} ms, bound {fm_bound} ms ({fm_by})")
        err = max(v["path_err"], fused["prologue_err"] if name == "int4_matmul" else 0.0)
        rows.append(_row(name, src, line, v["launches"][name], err, k_ms, p_ms, bound,
                         by, lib, fm_gemm_ms=fm_ms, fm_gemm_plain_ms=fm_plain,
                         fm_gemm_bound_ms=fm_bound, fm_gemm_library_ms=fm_lib,
                         fm_gemm_rows=rows_fm))

    # decode attention at the single-utterance cache, middle step
    s_len, d = fused["cache_len"], AR_HIDDEN // AR_HEADS
    valid = (fused["prompt_len"] + s_len) // 2
    q = torch.randn((1, AR_HEADS, d), generator=g, device=dev)
    ck, cv = (torch.randint(-127, 128, (1, AR_HEADS, s_len, d), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((1, AR_HEADS, s_len), generator=g, device=dev) * 0.02 for _ in range(2))
    lens = torch.tensor([valid], device=dev, dtype=torch.int32)
    a_ms = graph_ms(lambda: [decode_attention_int8(q, ck, cv, ks, vs, lens)
                             for _ in range(AR_LAYERS)]) / AR_LAYERS
    a_plain = graph_ms(lambda: decode_attention_int8_ref(q, ck, cv, ks, vs, lens))
    a_bound, a_by = _bound(4.0 * AR_HEADS * valid * d,
                           AR_HEADS * valid * (2 * d + 8) + 8 * AR_HEADS * d + 4)
    log(f"timing decode_attn_int8: (1, {AR_HEADS}, S={s_len}, {d}) valid_len {valid}, device "
        f"time of a CUDA-graph replay, mean of {AR_LAYERS} calls (one step's): kernel "
        f"{a_ms} ms, plain {a_plain} ms, bound {a_bound} ms ({a_by}), library none "
        "(no single PyTorch call attends over an int8 cache)")
    rows.append(_row("decode_attn_int8", "decode_attn_int8.cu", 1202, fused["attn_launches"],
                     fused["attn_err"], a_ms, a_plain, a_bound, a_by, None))
    return rows


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
    from amphion_tpu_torch.ops.kernels import flash_attention as flash_mod
    from amphion_tpu_torch.ops.kernels.decode_attention import DECODE_ATTN
    from amphion_tpu_torch.ops.kernels.flash_attention import FLASH
    from amphion_tpu_torch.ops.kernels.int4_matmul import INT4_MM
    from amphion_tpu_torch.ops.kernels.int8_matmul import INT8_MM
    from amphion_tpu_torch.ops.kernels.mel import MEL
    from amphion_tpu_torch.utils.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip().splitlines()[-1]
    card = nvidia_smi()
    log(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, nvcc {nvcc!r}, card {card!r}")
    kernels = {"mel": MEL, "flash_attn_fwd": FLASH, "int8_matmul": INT8_MM,
               "int4_matmul": INT4_MM, "decode_attn_int8": DECODE_ATTN}
    t0 = time.perf_counter()
    _build.build_all(list(kernels.values()))
    log(f"build: {', '.join(k.source.name for k in kernels.values())} in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")

    errs = kernel_phase(mel_mod, flash_mod, args.seed)
    quant_kernel_phase(args.seed)
    reference_phase(args.seed)
    ar_reference_phase(args.seed)
    sl = slice_phase(args.seed, MEL, FLASH)
    rows = timing_phase(mel_mod, flash_mod, sl, errs)
    cfg = load_config("config/vevo.json")
    v8 = voice_phase(cfg, args.seed, "int8", None, args.max_new, kernels, solo_check=True)
    v4 = voice_phase(cfg, args.seed, "int4", v8["audio"], args.max_new, kernels,
                     solo_check=False)
    fused = fused_phase(v8, v4, args.seed, args.max_new, kernels)
    padding_phase(v8)
    rows += quant_timing_phase(v8, v4, fused)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
