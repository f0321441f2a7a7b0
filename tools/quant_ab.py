#!/usr/bin/env python3
"""Build versions of the weight-only int8/int4 matmul kernels side by side and time them in turns.

Each argument is a directory holding another version of ``int8_matmul.cu``
and ``int4_matmul.cu`` with ``quant_common.cuh``, for instance an older tree
unpacked by ``git archive``; the repository's own
``amphion_tpu_torch/ops/kernels/csrc`` is always the first version, "base".
Each version is built under its own name (one nvcc per source, all at once)
and swapped into the wrappers (`int8_matmul`, `int4_matmul`). Then, on one
card, with random weights at the Vevo AR decoder's projections (24 layers of
qkv, o, gateup and down, so a decode step streams more than the L2 holds):

- each version against the plain versions at every projection and M = 1, 4
  and 8, with and without int4's RMSNorm prologue, whether a relaunch gives
  the same bits and whether row r at M = 1 and M = 4 equals row r at M = 8;
  and at GEMM sizes (M > 8: the AR prefill's and the flow-matching qkv's
  shapes) whether its outputs equal base's bit for bit;
- each version timed by CUDA-graph replays (``chip_smoke.graph_ms``) in the
  order base, v1, ..., vn, vn, ..., base: per projection (24 calls a replay,
  microseconds per call) at M = 1, 4 and 8, int4 also with the prologue on
  qkv and gateup (the projections it fuses), and one whole decode step of
  96 projections at M = 4 (int4 with and without the prologue), beside each
  one's byte bound and ``torch._weight_int{8,4}pack_mm``;
- each version's registers and spills (``nvcc -Xptxas -v``).

Run from the repository root on a machine with a card (``--json PATH``
also writes every timing row, with the card's name, to PATH):

    python3 tools/quant_ab.py [DIR ...] [--json PATH]
"""

from __future__ import annotations

import argparse
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
from amphion_tpu_torch.ops.kernels import int4_matmul as i4m  # noqa: E402
from amphion_tpu_torch.ops.kernels import int8_matmul as i8m  # noqa: E402
from chip_smoke import (AR_LAYERS, AR_PROJ, HBM, graph_ms, nvidia_smi,  # noqa: E402
                        quant_close)

LABELS = ("qkv", "o", "gateup", "down")
PROLOGUE = ("qkv", "gateup")  # the projections AMPHION_FUSED_RMS=1 normalises in the kernel
ROWS = (1, 4, 8)
# (M, K, N) past the GEMV: the smallest GEMM, the voice batch's AR prefill qkv and FM qkv
GEMM_CASES = ((9, 1280, 1280), (2316, 1280, 3840), (5120, 1024, 3072))


def versions(dirs: list[str], scratch: Path) -> dict:
    """name → {"int8": Kernel, "int4": Kernel}, each source copied with its
    headers under a name of its own."""
    out = {}
    for name, src_dir in [("base", _build.CSRC)] + [(Path(d).name, Path(d)) for d in dirs]:
        dst = scratch / name
        dst.mkdir(parents=True)
        for f in src_dir.glob("*.cuh"):
            shutil.copy(f, dst / f.name)
        pair = {}
        for key, ref in (("int8", i8m.INT8_MM), ("int4", i4m.INT4_MM)):
            src = dst / f"{ref.name}_{name}.cu"
            shutil.copy(src_dir / f"{ref.name}.cu", src)
            k = _build.Kernel(src.stem, ref.signatures)
            k.source = src
            pair[key] = k
        out[name] = pair
    t0 = time.time()
    jobs = {k.name: k.compile_process() for pair in out.values() for k in pair.values()}
    for name in list(out):
        try:
            for k in out[name].values():
                _build.Kernel.finish(jobs[k.name])
                k.lib()
        except RuntimeError as exc:
            print(f"{name} does not build:\n{str(exc)[:3000]}", flush=True)
            del out[name]
    print(f"built {len(out)} versions in {time.time() - t0:.1f} s", flush=True)
    return out


def weights(g) -> dict:
    """label → [(int8 w_q, scale), ...] and [(int4 w_p, scale), ...] over
    AR_LAYERS layers, plus an RMSNorm gain per K."""
    dev = "cuda"
    out = {}
    for label, (k, n) in zip(LABELS, AR_PROJ):
        w8, w4 = [], []
        for _ in range(AR_LAYERS):
            w = (torch.randn((n, k), generator=g, device=dev) * 0.03).bfloat16()
            w8.append(i8m.quantize_weight_int8(w))
            w_int, sc = i4m.quantize_weight_int4(w, 128)
            w4.append((i4m.pack_int4(w_int), sc))
        out[label] = {"k": k, "n": n, "int8": w8, "int4": w4,
                      "gain": 1 + 0.1 * torch.randn((k,), generator=g, device=dev)}
    return out


def run(kind: str, x, wt, gain=None, dt=torch.bfloat16):
    if kind == "int8":
        return i8m.int8_matmul(x, wt[0], wt[1], dt)
    return i4m.int4_matmul(x, wt[0], wt[1], 128, gain, 1e-6, dt)


def plain(kind: str, x, wt, gain=None, dt=torch.float32):
    if kind == "int8":
        return i8m.int8_matmul_ref(x, wt[0], wt[1], dt)
    return i4m.int4_matmul_ref(x, wt[0], wt[1], 128, gain, 1e-6, dt)


def bytes_of(kind: str, m: int, k: int, n: int) -> int:
    """Bytes one projection must move: weights, scales, x and out (bf16)."""
    w = n * k if kind == "int8" else n * k // 2
    s = 4 * n if kind == "int8" else 4 * n * (k // 128)
    return w + s + 2 * m * k + 2 * m * n


def tinygemm(w_p, scale):
    """The packed int4 weight in the layout of ``torch._weight_int4pack_mm``
    (values offset by 8, the high nibble first, zero points 0)."""
    u = i4m.unpack_int4(w_p).to(torch.int32) + 8
    packed = torch._convert_weight_to_int4pack(((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 8)
    sz = torch.stack([scale, torch.zeros_like(scale)], dim=-1).bfloat16()
    return packed, 128, sz


def library(kind: str, ws: list, x):
    """One PyTorch call per projection computing the same product (checked
    against the plain version on the first), or None."""
    try:
        if kind == "int8":
            args = [(w, s.bfloat16()) for w, s in ws]
            fn = torch._weight_int8pack_mm
        else:
            args = [tinygemm(w, s) for w, s in ws]
            fn = torch._weight_int4pack_mm
        ref = plain(kind, x, ws[0])
        if (fn(x, *args[0]).float() - ref).abs().max().item() > 2e-2 * ref.abs().max().item():
            return None
        return lambda: [fn(x, *a) for a in args]
    except (RuntimeError, AttributeError, NotImplementedError):
        return None


def checks(kern: dict, proj: dict, g) -> None:
    """Each version against the plain versions, relaunched and row by row;
    at GEMM sizes against base's bits. A version whose launch fails is
    reported and dropped."""
    first = {}
    for name, pair in list(kern.items()):
        try:
            check_version(name, pair, proj, g, first)
        except RuntimeError as exc:
            print(f"{name:>10}: {exc}; dropped", flush=True)
            del kern[name]


def check_version(name: str, pair: dict, proj: dict, g, first: dict) -> None:
    i8m.INT8_MM, i4m.INT4_MM = pair["int8"], pair["int4"]
    bad = []
    for label, p in proj.items():
        k = p["k"]
        x8 = torch.randn((8, k), generator=g, device="cuda").bfloat16()
        for kind in ("int8", "int4"):
            for gain in ([None, p["gain"]] if kind == "int4" else [None]):
                wt = p[kind][0]
                outs = {m: run(kind, x8[:m], wt, gain, torch.float32) for m in ROWS}
                for m in ROWS:
                    ok, detail = quant_close(outs[m], plain(kind, x8[:m], wt, gain), gain is not None)
                    if not ok:
                        bad.append(f"{kind} {label} M={m} prologue={gain is not None}: {detail}")
                same = torch.equal(run(kind, x8, wt, gain, torch.float32), outs[8])
                rows = (torch.equal(outs[4], outs[8][:4]) and torch.equal(outs[1], outs[8][:1])
                        and all(torch.equal(run(kind, x8[r:r + 1], wt, gain, torch.float32)[0],
                                            outs[8][r]) for r in range(8)))
                if not (same and rows):
                    bad.append(f"{kind} {label} prologue={gain is not None}: relaunch "
                               f"bit-equal {same}, row-invariant {rows}")
    gemm = []
    for m, k, n in GEMM_CASES:
        gg = torch.Generator("cuda").manual_seed(m)
        x = torch.randn((m, k), generator=gg, device="cuda")
        w = (torch.randn((n, k), generator=gg, device="cuda") * 0.03).bfloat16()
        w_int, sc = i4m.quantize_weight_int4(w, 128)
        wts = {"int8": i8m.quantize_weight_int8(w), "int4": (i4m.pack_int4(w_int), sc)}
        gain = 1 + 0.1 * torch.randn((k,), generator=gg, device="cuda")
        for kind in ("int8", "int4"):
            for gn in ([None, gain] if kind == "int4" else [None]):
                for xx, dt in ((x, torch.float32), (x.bfloat16(), torch.bfloat16)):
                    gemm.append(run(kind, xx, wts[kind], gn, dt))
    if first:
        eq = [torch.equal(a, b) for a, b in zip(gemm, first["base"])]
        print(f"{name:>10}: GEMM outputs (M, K, N in {GEMM_CASES}; int8, int4, int4 with "
              f"the prologue; f32 and bf16) bit-equal to base in {sum(eq)}/{len(eq)}",
              flush=True)
    else:
        first["base"] = gemm
    print(f"{name:>10}: GEMV checks (plain within quant_close, relaunch, row invariance at "
          f"M = 1, 4, 8): {'all passed' if not bad else 'FAILED ' + '; '.join(bad)}",
          flush=True)
    torch.cuda.synchronize()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="*", help="directories holding other versions")
    ap.add_argument("--json", help="write the timing rows here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("quant_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        kern = versions(args.dirs, Path(tmp))
        print(nvidia_smi(), flush=True)
        g = torch.Generator("cuda").manual_seed(0)
        proj = weights(g)
        checks(kern, proj, g)
        xs = {m: {k: torch.randn((m, k), generator=g, device="cuda").bfloat16()
                  for k in {p["k"] for p in proj.values()}} for m in ROWS}

        def cases():
            """(case name, kind, list of (x, weight, gain)) of every timing."""
            for m in ROWS:
                for label, p in proj.items():
                    for kind in ("int8", "int4"):
                        yield (f"{kind} M={m} {label}", kind,
                               [(xs[m][p["k"]], w, None) for w in p[kind]])
                    if label in PROLOGUE:
                        yield (f"int4+rms M={m} {label}", "int4",
                               [(xs[m][p["k"]], w, p["gain"]) for w in p["int4"]])
            for kind, pro in (("int8", False), ("int4", False), ("int4", True)):
                calls = []
                for i in range(AR_LAYERS):
                    for label, p in proj.items():
                        calls.append((xs[4][p["k"]], p[kind][i],
                                      p["gain"] if pro and label in PROLOGUE else None))
                yield (f"{kind}{'+rms' if pro else ''} decode step (96 projections, M=4)", kind,
                       calls)

        times = {}
        for name in list(kern) + list(kern)[::-1]:
            i8m.INT8_MM, i4m.INT4_MM = kern[name]["int8"], kern[name]["int4"]
            for case, kind, calls in cases():
                ms = graph_ms(lambda: [run(kind, x, w, gn) for x, w, gn in calls])
                times.setdefault(case, {}).setdefault(name, []).append(ms)
        rows = []
        for case, kind, calls in cases():
            per_call = "step" not in case
            div = len(calls) if per_call else 1
            unit, f = ("us", 1e3) if per_call else ("ms", 1.0)
            m = calls[0][0].shape[0]
            nbytes = sum(bytes_of(kind, m, x.shape[1], w[0].shape[0]) for x, w, _ in calls) / div
            lib = None
            if all(gn is None for _, _, gn in calls):
                by_w = {}
                for x, w, _ in calls:
                    by_w.setdefault(x.shape[1], []).append(w)
                fns = [library(kind, ws, next(x for x, w, _ in calls if x.shape[1] == k))
                       for k, ws in by_w.items()]
                if all(fns):
                    lib = graph_ms(lambda: [fn() for fn in fns]) / div * f
            row = {"case": case, "bound_" + unit: nbytes / HBM * 1e3 * f,
                   "library_" + unit: lib,
                   **{f"{n}_{unit}": [t / div * f for t in ts] for n, ts in times[case].items()}}
            rows.append(row)
            print(f"{case:>52}: " + "  ".join(
                f"{n} " + " ".join(f"{t / div * f:.4f}" for t in ts)
                for n, ts in times[case].items())
                + f"  | bound {nbytes / HBM * 1e3 * f:.4f}"
                + (f", library {lib:.4f}" if lib is not None else ", library none") + f" {unit}",
                flush=True)
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps({"card": nvidia_smi(), "rows": rows}, indent=1))
        procs = [(k, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / f"{k.name}_v.so"), str(k.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for pair in kern.values() for k in pair.values()]
        for k, proc in procs:
            cur = ""
            for line in proc.communicate()[0].splitlines():
                if "Compiling entry function" in line:
                    cur = line.split("'")[1]
                elif ("registers" in line or "spill" in line) and "gemm" not in cur:
                    print(f"{k.name} {cur[:70]}: {line.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
