#!/usr/bin/env python3
"""Build versions of kernels #8, #2, #3 and #1 side by side and time them in turns.

The kernels: the decode attention (#8, ``decode_attn_int8.cu``), the
anti-aliased SnakeBeta (#2, ``aa_snake.cu``), the log-mel front end (#3,
``mel.cu``) and Snake's forward and backward (#1, ``snake.cu``). Each
argument is a directory holding another version of those sources with the
headers they include, for instance the parent commit's ``csrc`` files from
``git show`` in an ignored directory, and, where that version's C interface
differs from the repository's, its wrappers (``decode_attention.py``,
``aa_snake.py``, ``mel.py``, ``snake.py``); the repository's own
``amphion_tpu_torch/ops/kernels`` is always the first version, "base". Each
version is built under its own name (one nvcc per source, all at once) and
called through its own wrappers. ``--kernels`` picks which of the four are
built, checked and timed (all by default). Then, on one card, with random
inputs from a fixed seed:

- #8 against its plain version within 1e-4 of max|ref| and relaunched bit
  for bit, at the fused single-utterance decode's cache (1, 20, 1272, 64)
  at each ``--lens`` valid length, at B = 4 with ragged lengths and at
  D = 128;
- #2 against its plain version, bit for bit in float32 and within one bf16
  step in bf16, at the five shapes of a 10 s file's activations and a
  ragged one;
- #3 within 1e-3 of its plain version and of the same arithmetic in
  float64 on the log-mel, and relaunched bit for bit, at the timbre batch's
  lengths (the Vevo front end), at B = 4 with a frame count that is not a
  multiple of 4, at T one sample above the pad, and at bigvgan_large's
  front end (hop 256, window 1024, 100 mels);
- #1's y and dx equal to their plain versions' float32 results to the bit
  (within one bf16 step in bf16) and dalpha within 1e-5 of max|ref|, all
  three relaunched bit for bit, at the egs training batch's four AMP shapes
  and a C that is not a multiple of 4;
- for each kernel, in how many cases its outputs equal base's to the bit;
- each version timed by CUDA-graph replays (``chip_smoke.graph_ms``) in the
  order base, v1, ..., vn, vn, ..., base: #8 per call at each valid length,
  as one decode step runs it (24 calls on 24 layers' caches, which stream
  from device memory) and on one cache called 24 times (L2-resident); #2
  per launch at each shape of the file and their mean weighted by the
  file's launches (18 at each stage's shape, 19 at the last); #3 per call
  as the mean over a timbre batch's 12 calls, beside the library chain
  (``chip_smoke.library_mel``: torch.stft, mel matmul, log) timed the same
  way before and after; #1's forward and backward at each AMP shape and
  their means, on one input set (which stays in L2 from call to call, as
  ``chip_smoke.py`` times it) and on four in turn (streaming from device
  memory); each beside its bound;
- each version's registers and spills (``nvcc -Xptxas -v``).

Run from the repository root on a machine with a card (``--json PATH``
also writes every timing row, with the card's name, to PATH):

    python3 tools/kernel_ab.py [DIR ...] [--kernels decode aa mel snake]
        [--lens 505 888 1272] [--json PATH]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from amphion_tpu_torch.ops.kernels import _build  # noqa: E402
from amphion_tpu_torch.ops.kernels import aa_snake as aam  # noqa: E402
from amphion_tpu_torch.ops.kernels import decode_attention as dam  # noqa: E402
from amphion_tpu_torch.ops.kernels import mel as melm  # noqa: E402
from amphion_tpu_torch.ops.kernels import snake as snm  # noqa: E402
from amphion_tpu_torch.ops.mel import MelConfig, _fbank  # noqa: E402
from chip_smoke import (AA_OPS, AMP_SHAPES, AR_HEADS, AR_LAYERS, HBM, MEL_LARGE,  # noqa: E402
                        PEAK_F32, REQUESTS, SNAKE_BWD_OPS, SNAKE_OPS, _bound, graph_ms,
                        grid_len, library_mel, mel_work, nvidia_smi, within_bf16_step)

D, S = 64, 1272  # the fused single-utterance decode's head dim and cache length
# (B, T, C) of a 10 s file's kernel-2 launches at batch 1 and their counts
AA_SHAPES = {(1, 10000, 256): 18, (1, 40000, 128): 18, (1, 120000, 64): 18,
             (1, 240000, 32): 19}
AA_EXTRA = [(2, 5001, 48), (1, 12, 40)]  # a partial last run, C in 33-63; T < 13
# the (1, T) lengths of a timbre batch's 12 mel calls (reference twice, source once)
MEL_LENGTHS = sorted(grid_len(x) for r, s in REQUESTS for x in (r, r, s))
SNAKE_EXTRA = [(2, 300, 37)]  # C % 4 != 0: one channel a thread
SNAKE_SETS = 4
KERNELS = {"decode": ("decode_attn_int8", "decode_attention", "DECODE_ATTN", dam),
           "aa": ("aa_snake", "aa_snake", "AA_SNAKE", aam),
           "mel": ("mel", "mel", "MEL", melm),
           "snake": ("snake", "snake", "SNAKE", snm)}


def wrapper(py: Path, name: str):
    """A version's wrapper module, loaded under a name of its own so that
    its kernel can be swapped."""
    spec = importlib.util.spec_from_file_location(f"kernel_ab_{name}_{py.stem}", py)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def versions(dirs: list[str], scratch: Path, keys: list[str]) -> dict:
    """name → {key: wrapper module}, each with its own Kernel: the source
    copied with its headers under a name of its own, called through the
    version's wrappers where its directory holds them (else the
    repository's)."""
    out = {}
    for name, src_dir in [("base", _build.CSRC)] + [(Path(d).name, Path(d)) for d in dirs]:
        dst = scratch / name
        dst.mkdir(parents=True)
        for f in src_dir.glob("*.cuh"):
            shutil.copy(f, dst / f.name)
        mods = {}
        for key in keys:
            stem, py_stem, attr, repo_mod = KERNELS[key]
            py = src_dir / f"{py_stem}.py"
            mod = wrapper(py if name != "base" and py.exists() else Path(repo_mod.__file__), name)
            src = dst / f"{stem}_{name}.cu"
            shutil.copy(src_dir / f"{stem}.cu", src)
            k = _build.Kernel(src.stem, getattr(mod, attr).signatures)
            k.source = src
            setattr(mod, attr, k)
            mods[key] = mod
        out[name] = mods
    t0 = time.time()
    jobs = {kernel(key, m).name: kernel(key, m).compile_process()
            for mods in out.values() for key, m in mods.items()}
    for name in list(out):
        try:
            for key, m in out[name].items():
                _build.Kernel.finish(jobs[kernel(key, m).name])
                kernel(key, m).lib()
        except RuntimeError as exc:
            print(f"{name} does not build:\n{str(exc)[:3000]}", flush=True)
            del out[name]
    print(f"built {len(out)} versions in {time.time() - t0:.1f} s", flush=True)
    return out


def kernel(key: str, mod) -> _build.Kernel:
    """The Kernel a wrapper module launches."""
    return getattr(mod, KERNELS[key][2])


def decode_inputs(g, b: int, h: int, s: int, d: int, lens: list):
    q = torch.randn((b, h, d), generator=g, device="cuda")
    ck, cv = (torch.randint(-127, 128, (b, h, s, d), generator=g, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, h, s), generator=g, device="cuda") * 0.02 for _ in range(2))
    return q, ck, cv, ks, vs, torch.tensor(lens, device="cuda", dtype=torch.int32)


def aa_inputs(g, shape):
    x = torch.randn(shape, generator=g, device="cuda") * 3
    alpha, beta = (torch.rand(shape[-1], generator=g, device="cuda") * 1.5 + 0.5
                   for _ in range(2))
    return x, alpha, beta


def snake_inputs(g, shape, dtype=torch.float32):
    x = (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)
    alpha = torch.rand(shape[-1], generator=g, device="cuda") * 1.5 + 0.5
    return x, alpha, torch.randn(shape, generator=g, device="cuda").to(dtype)


def mel_args(cfg: MelConfig) -> tuple:
    """log_mel's arguments after the signal."""
    return (_fbank(cfg, torch.device("cuda")), cfg.n_fft, cfg.hop_size, cfg.win_size,
            cfg.clip_val)


def check_decode(mod, args, bad: list) -> list:
    out = mod.decode_attention_int8(*args)
    ref = dam.decode_attention_int8_ref(*args)
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    same = torch.equal(mod.decode_attention_int8(*args), out)
    if not (err <= 1e-4 * scale and same):
        bad.append(f"#8 {tuple(args[1].shape)}: max|err| {err:.3g} (tol 1e-4 of {scale:.3g}), "
                   f"relaunch bit-equal {same}")
    return [out]


def check_aa(mod, args, bad: list) -> list:
    x, alpha, beta = args
    out = mod.aa_snakebeta(x, alpha, beta)
    ref = aam.aa_snakebeta_ref(x, alpha, beta)
    if not torch.equal(out, ref):
        bad.append(f"#2 {tuple(x.shape)} float32: max|err| {(out - ref).abs().max().item():.3g} "
                   "(want bit-equal)")
    out16 = mod.aa_snakebeta(x.bfloat16(), alpha, beta)
    ok, detail = within_bf16_step(out16, aam.aa_snakebeta_ref(x.bfloat16(), alpha, beta))
    if not ok:
        bad.append(f"#2 {tuple(x.shape)} bf16: {detail}")
    return [out, out16]


def check_mel(mod, args, bad: list, errs: dict) -> list:
    y, cfg = args
    out = mod.log_mel(y, *mel_args(cfg))
    ref = melm.log_mel_ref(y, *mel_args(cfg))
    f64 = melm.log_mel_f64(y, *mel_args(cfg))
    err, err64 = (out - ref).abs().max().item(), (out.double() - f64).abs().max().item()
    errs["kernel_vs_plain"] = max(errs.get("kernel_vs_plain", 0.0), err)
    errs["kernel_vs_f64"] = max(errs.get("kernel_vs_f64", 0.0), err64)
    errs["plain_vs_f64"] = max(errs.get("plain_vs_f64", 0.0),
                               (ref.double() - f64).abs().max().item())
    same = torch.equal(mod.log_mel(y, *mel_args(cfg)), out)
    if not (err <= 1e-3 and err64 <= 1e-3 and same):
        bad.append(f"#3 {tuple(y.shape)} hop {cfg.hop_size}: max|err| {err:.3g}, against float64 "
                   f"{err64:.3g} (tol 1e-3), relaunch bit-equal {same}")
    return [out]


def check_snake(mod, args, bad: list) -> list:
    x, alpha, g = args
    y, (dx, da) = mod.snake(x, alpha), mod.snake_bwd(x, alpha, g)
    ref_y, (ref_dx, ref_da) = snm.snake_ref(x, alpha), snm.snake_bwd_ref(x, alpha, g)
    if x.dtype == torch.float32:
        ok = torch.equal(y, ref_y) and torch.equal(dx, ref_dx)
        detail = f"y, dx bit-equal {ok}"
    else:
        (ok_y, d_y), (ok_x, d_x) = within_bf16_step(y, ref_y), within_bf16_step(dx, ref_dx)
        ok, detail = ok_y and ok_x, f"y: {d_y}; dx: {d_x}"
    err = ((da - ref_da).abs().max() / ref_da.abs().max()).item()
    y2, (dx2, da2) = mod.snake(x, alpha), mod.snake_bwd(x, alpha, g)
    same = torch.equal(y, y2) and torch.equal(dx, dx2) and torch.equal(da, da2)
    if not (ok and err <= 1e-5 and same):
        bad.append(f"#1 {tuple(x.shape)} {x.dtype}: {detail}, dalpha {err:.3g} of max|ref| "
                   f"(tol 1e-5), relaunch bit-equal {same}")
    return [y, dx, da]


def checks(kern: dict, lens: list, keys: list[str]) -> None:
    """Each version against the plain versions and relaunched, its outputs
    against base's bits. A version whose launch fails is dropped."""
    g = torch.Generator("cuda").manual_seed(1)
    cfg, large = MelConfig(), MelConfig(**MEL_LARGE)
    cases = {
        "decode": [decode_inputs(g, 1, AR_HEADS, S, D, [n]) for n in lens]
        + [decode_inputs(g, 4, AR_HEADS, 1600, D, [1600, 1201, 256, 1]),
           decode_inputs(g, 2, 8, 300, 128, [300, 257])],
        "aa": [aa_inputs(g, shape) for shape in list(AA_SHAPES) + AA_EXTRA],
        "mel": [(torch.randn((b, t), generator=g, device="cuda") * 0.2, c) for c, b, t in
                [(cfg, 1, t) for t in sorted(set(MEL_LENGTHS))]
                + [(cfg, 4, 101 * 120 + 37), (cfg, 1, (cfg.n_fft - cfg.hop_size) // 2 + 1),
                   (large, 4, 91 * 256 + 5), (large, 1, 385)]],
        "snake": [snake_inputs(g, shape, dt) for dt in (torch.float32, torch.bfloat16)
                  for shape in AMP_SHAPES + SNAKE_EXTRA],
    }
    base = {}
    for name, mods in list(kern.items()):
        bad, outs, mel_errs = [], {}, {}
        try:
            for key in keys:
                fn = {"decode": check_decode, "aa": check_aa, "snake": check_snake,
                      "mel": lambda m, a, b: check_mel(m, a, b, mel_errs)}[key]
                outs[key] = [o for args in cases[key] for o in fn(mods[key], args, bad)]
            torch.cuda.synchronize()
        except RuntimeError as exc:
            print(f"{name:>10}: {exc}; dropped", flush=True)
            del kern[name]
            continue
        if base:
            for key in keys:
                eq = [torch.equal(a, b) for a, b in zip(outs[key], base[key])]
                print(f"{name:>10}: {key} outputs bit-equal to base in {sum(eq)}/{len(eq)}",
                      flush=True)
        else:
            base = outs
        if mel_errs:
            print(f"{name:>10}: #3 max|err| on the log-mel: " + ", ".join(
                f"{k} {v:.3g}" for k, v in mel_errs.items()), flush=True)
        print(f"{name:>10}: checks of {', '.join(keys)} at "
              f"{sum(len(cases[k]) for k in keys)} cases: "
              f"{'all passed' if not bad else 'FAILED ' + '; '.join(bad)}", flush=True)


def decode_bound(valid: int) -> float:
    """Bytes over the memory rate (K, V rows and scales up to valid, q, out)
    or operations over the bf16 rate, the larger, in ms."""
    return _bound(4.0 * AR_HEADS * valid * D, AR_HEADS * valid * (2 * D + 8)
                  + 8 * AR_HEADS * D + 4)[0]


def elementwise_bound(shape, ops: int, bytes_per_element: float, per_channel: float) -> float:
    """Operations over the float32 rate or bytes over the memory rate, the
    larger, in ms."""
    n = shape[0] * shape[1] * shape[2]
    return max(ops * n / PEAK_F32, (bytes_per_element * n + per_channel * shape[2]) / HBM) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="*", help="directories holding other versions")
    ap.add_argument("--kernels", nargs="+", choices=list(KERNELS), default=list(KERNELS),
                    help="which kernels to build, check and time")
    ap.add_argument("--lens", type=int, nargs="+", default=[505, 888, 1272],
                    help="#8's valid lengths: the fused run's first, middle and last steps")
    ap.add_argument("--json", help="write the timing rows here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    keys = args.kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        kern = versions(args.dirs, Path(tmp), keys)
        card = nvidia_smi()
        print(card, flush=True)
        checks(kern, args.lens, keys)
        g = torch.Generator("cuda").manual_seed(2)
        layers = {n: [decode_inputs(g, 1, AR_HEADS, S, D, [n]) for _ in range(AR_LAYERS)]
                  for n in args.lens} if "decode" in keys else {}
        aa = {shape: aa_inputs(g, shape) for shape in AA_SHAPES} if "aa" in keys else {}
        mel_ys = [torch.randn((1, t), generator=g, device="cuda") * 0.2 for t in MEL_LENGTHS]
        # #1 also over SNAKE_SETS input sets in turn, so that its inputs and
        # outputs (4 x 32 MB at the largest shape) stream from device memory
        # instead of staying in the 50 MB L2 from one call to the next
        snake = ({shape: [snake_inputs(g, shape) for _ in range(SNAKE_SETS)]
                  for shape in AMP_SHAPES} if "snake" in keys else {})
        fb = _fbank(MelConfig(), torch.device("cuda"))
        mel_bound = mel_work(MEL_LENGTHS, fb)[2]

        def cases():
            """(case, calls per replay, a function of the wrapper modules
            that runs them, bound ms per call)."""
            for n, calls in layers.items():
                yield (f"#8 valid_len {n}, one step (24 caches)", AR_LAYERS,
                       lambda mods, calls=calls: [mods["decode"].decode_attention_int8(*c)
                                                  for c in calls], decode_bound(n))
                yield (f"#8 valid_len {n}, one cache x 24", AR_LAYERS,
                       lambda mods, c=calls[0]: [mods["decode"].decode_attention_int8(*c)
                                                 for _ in range(AR_LAYERS)], decode_bound(n))
            for shape, xab in aa.items():
                yield (f"#2 {shape}", 1, lambda mods, xab=xab: mods["aa"].aa_snakebeta(*xab),
                       elementwise_bound(shape, AA_OPS, 8.0, 8))
            if "mel" in keys:
                yield (f"#3 mean per call over the timbre batch's {len(mel_ys)}", len(mel_ys),
                       lambda mods: [mods["mel"].log_mel(y, *mel_args(MelConfig()))
                                     for y in mel_ys], mel_bound)
            for shape, sets in snake.items():
                x, alpha, gout = sets[0]
                yield (f"#1 fwd {shape}", 1, lambda mods, x=x, a=alpha: mods["snake"].snake(x, a),
                       elementwise_bound(shape, SNAKE_OPS, 8.0, 4))
                yield (f"#1 bwd {shape}", 1,
                       lambda mods, x=x, a=alpha, go=gout: mods["snake"].snake_bwd(x, a, go),
                       elementwise_bound(shape, SNAKE_BWD_OPS, 12.0, 8))
                yield (f"#1 fwd {shape} streaming", SNAKE_SETS,
                       lambda mods, sets=sets: [mods["snake"].snake(x, a) for x, a, _ in sets],
                       elementwise_bound(shape, SNAKE_OPS, 8.0, 4))
                yield (f"#1 bwd {shape} streaming", SNAKE_SETS,
                       lambda mods, sets=sets: [mods["snake"].snake_bwd(*s) for s in sets],
                       elementwise_bound(shape, SNAKE_BWD_OPS, 12.0, 8))

        times, library = {}, []
        with torch.no_grad():
            if "mel" in keys:
                library.append(graph_ms(lambda: [library_mel(y, fb, 1e-5) for y in mel_ys])
                               / len(mel_ys))
            for name in list(kern) + list(kern)[::-1]:
                for case, n, fn, _ in cases():
                    ms = graph_ms(lambda: fn(kern[name])) / n
                    times.setdefault(case, {}).setdefault(name, []).append(ms)
            if "mel" in keys:
                library.append(graph_ms(lambda: [library_mel(y, fb, 1e-5) for y in mel_ys])
                               / len(mel_ys))
        rows = []

        def show(row):
            rows.append(row)
            print(f"{row['case']:>44}: " + "  ".join(
                f"{n} " + " ".join(f"{t * 1e3:.3f}" for t in row[f"{n}_ms"]) for n in kern)
                + f"  | bound {row['bound_ms'] * 1e3:.3f} us", flush=True)

        for case, _, _, bound in cases():
            show({"case": case, "bound_ms": bound,
                  **{f"{n}_ms": ts for n, ts in times[case].items()}})

        def mean_row(case, parts: dict):
            """The mean of the cases ``parts`` (case → weight) per version."""
            w = sum(parts.values())
            row = {"case": case, "bound_ms": sum(
                next(b for c, _, _, b in cases() if c == p) * k for p, k in parts.items()) / w}
            for name in kern:
                row[f"{name}_ms"] = [sum(times[p][name][i] * k for p, k in parts.items()) / w
                                     for i in range(2)]
            show(row)

        if aa:
            mean_row("#2 mean per launch over a 10 s file's 73",
                     {f"#2 {s}": c for s, c in AA_SHAPES.items()})
        if snake:
            for kind in ("fwd", "bwd", "fwd streaming", "bwd streaming"):
                name, how = kind.split()[0], kind[3:]
                mean_row(f"#1 {name} mean over the AMP shapes{how}",
                         {f"#1 {name} {s}{how}": 1 for s in AMP_SHAPES})
        if library:
            rows.append({"case": "#3 library chain (torch.stft, mel matmul, log), per call",
                         "library_ms": library})
            print(f"{rows[-1]['case']:>44}: before " + " / after ".join(
                f"{t * 1e3:.3f}" for t in library) + " us", flush=True)
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps({"card": card, "rows": rows}, indent=1))
        procs = [(kernel(key, m), subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / f"{kernel(key, m).name}_v.so"), str(kernel(key, m).source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for mods in kern.values() for key, m in mods.items()]
        for k, proc in procs:
            cur = ""
            for line in proc.communicate()[0].splitlines():
                if "Compiling entry function" in line:
                    cur = line.split("'")[1]
                elif "registers" in line or "spill" in line or "warning" in line:
                    print(f"{k.name} {cur[:90]}: {line.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
