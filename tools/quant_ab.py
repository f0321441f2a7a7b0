#!/usr/bin/env python3
"""Build versions of the weight-only int8/int4 matmul kernels side by side and time them in turns.

Each argument is a directory holding another version of ``int8_matmul.cu``
and ``int4_matmul.cu`` with the headers they include, for instance an older
tree unpacked by ``git archive``, and, where that version's C interface
differs from the repository's, its wrappers ``int8_matmul.py`` and
``int4_matmul.py``; the repository's own ``amphion_tpu_torch/ops/kernels``
is always the first version, "base". Each version is built under its own
name (one nvcc per source, all at once) and called through its own
wrappers. Then, on one card, with random weights:

- at the Vevo AR decoder's projections (24 layers of qkv, o, gateup and
  down, so a decode step streams more than the L2 holds), each version's
  GEMV against the plain versions at M = 1, 4 and 8, with and without
  int4's RMSNorm prologue, whether a relaunch gives the same bits, whether
  row r at M = 1 and M = 4 equals row r at M = 8, and whether its outputs
  equal base's bit for bit;
- at GEMM sizes (M > 8: the smallest GEMM, the voice batch's AR prefill
  and flow-matching qkv), each version's GEMM within `quant_close` of the
  plain version, whether a relaunch gives the same bits, whether row r
  at M = 129 equals row r at the full M (reported, not required) and
  whether its outputs equal base's bit for bit, from float32 and bf16 x;
- each version timed by CUDA-graph replays (``chip_smoke.graph_ms``) in the
  order base, v1, ..., vn, vn, ..., base: per projection (24 calls a replay,
  microseconds per call) at M = 1, 4 and 8, int4 also with the prologue on
  qkv and gateup (the projections it fuses), one whole decode step of 96
  projections at M = 4 (int4 with and without the prologue), beside each
  one's byte bound and ``torch._weight_int{8,4}pack_mm``; and the GEMM at
  every flow-matching projection at M = 5120 rows and every AR prefill
  projection at M = 2316 (int4 also with the prologue on qkv and gateup),
  beside its operation bound, the library call and, labelled as a
  reference and not a yardstick, ``torch.matmul`` in bf16 on the
  dequantized weight;
- each version's registers and spills (``nvcc -Xptxas -v``).

Run from the repository root on a machine with a card (``--json PATH``
also writes every timing row, with the card's name, to PATH):

    python3 tools/quant_ab.py [DIR ...] [--json PATH]
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
from amphion_tpu_torch.ops.kernels import int4_matmul as i4m  # noqa: E402
from amphion_tpu_torch.ops.kernels import int8_matmul as i8m  # noqa: E402
from chip_smoke import (AR_LAYERS, AR_PROJ, FM_HIDDEN, HBM, PEAK_BF16, graph_ms,  # noqa: E402
                        nvidia_smi, quant_close)

LABELS = ("qkv", "o", "gateup", "down")
PROLOGUE = ("qkv", "gateup")  # the projections AMPHION_FUSED_RMS=1 normalises in the kernel
ROWS = (1, 4, 8)
# (M, K, N) past the GEMV: the smallest GEMM, the voice batch's AR prefill qkv and FM qkv
GEMM_CASES = ((9, 1280, 1280), (2316, 1280, 3840), (5120, 1024, 3072))
ROW_M = 129  # rows whose outputs are compared with the same rows at a case's full M
# the voice batch's GEMMs: its flow-matching rows (4 requests x 1280 frames)
# and its AR prefill rows (4 x 579), with (K, N) of qkv, o, gateup, down
FM_ROWS, PREFILL_ROWS = 5120, 2316
FM_PROJ = [(FM_HIDDEN, 3 * FM_HIDDEN), (FM_HIDDEN, FM_HIDDEN), (FM_HIDDEN, 8 * FM_HIDDEN),
           (4 * FM_HIDDEN, FM_HIDDEN)]
ACTIVE = {}  # the version being run: {"int8": wrapper module, "int4": wrapper module}


def wrapper(py: Path, name: str):
    """A version's wrapper module (``int8_matmul.py`` or ``int4_matmul.py``),
    loaded under a name of its own so that its kernel can be swapped."""
    spec = importlib.util.spec_from_file_location(f"quant_ab_{name}_{py.stem}", py)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def versions(dirs: list[str], scratch: Path) -> dict:
    """name → {"int8": wrapper module, "int4": wrapper module}, each with
    its own Kernel: the source copied with its headers under a name of its
    own, called through the version's wrappers where its directory holds
    them (else the repository's)."""
    out = {}
    for name, src_dir in [("base", _build.CSRC)] + [(Path(d).name, Path(d)) for d in dirs]:
        dst = scratch / name
        dst.mkdir(parents=True)
        for f in src_dir.glob("*.cuh"):
            shutil.copy(f, dst / f.name)
        mods = {}
        for key, repo_mod in (("int8", i8m), ("int4", i4m)):
            stem = f"{key}_matmul"
            py = src_dir / f"{stem}.py"
            mod = wrapper(py if name != "base" and py.exists() else Path(repo_mod.__file__), name)
            attr = "INT8_MM" if key == "int8" else "INT4_MM"
            src = dst / f"{stem}_{name}.cu"
            shutil.copy(src_dir / f"{stem}.cu", src)
            k = _build.Kernel(src.stem, getattr(mod, attr).signatures)
            k.source = src
            setattr(mod, attr, k)
            mods[key] = mod
        out[name] = mods
    t0 = time.time()
    jobs = {kernel(m).name: kernel(m).compile_process() for mods in out.values()
            for m in mods.values()}
    for name in list(out):
        try:
            for m in out[name].values():
                _build.Kernel.finish(jobs[kernel(m).name])
                kernel(m).lib()
        except RuntimeError as exc:
            print(f"{name} does not build:\n{str(exc)[:3000]}", flush=True)
            del out[name]
    print(f"built {len(out)} versions in {time.time() - t0:.1f} s", flush=True)
    return out


def kernel(mod):
    """The Kernel a wrapper module launches."""
    return getattr(mod, "INT8_MM", None) or mod.INT4_MM


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
    """The active version's kernel (`activate`)."""
    if kind == "int8":
        return ACTIVE["int8"].int8_matmul(x, wt[0], wt[1], dt)
    return ACTIVE["int4"].int4_matmul(x, wt[0], wt[1], 128, gain, 1e-6, dt)


def activate(mods: dict) -> None:
    ACTIVE.update(mods)


def plain(kind: str, x, wt, gain=None, dt=torch.float32):
    if kind == "int8":
        return i8m.int8_matmul_ref(x, wt[0], wt[1], dt)
    return i4m.int4_matmul_ref(x, wt[0], wt[1], 128, gain, 1e-6, dt)


def bytes_of(kind: str, m: int, k: int, n: int) -> int:
    """Bytes one projection must move: weights, scales, x and out (bf16)."""
    w = n * k if kind == "int8" else n * k // 2
    s = 4 * n if kind == "int8" else 4 * n * (k // 128)
    return w + s + 2 * m * k + 2 * m * n


def bound_ms(kind: str, m: int, k: int, n: int) -> float:
    """The least time of one projection: its bytes over the memory rate or
    its bf16 operations over the tensor cores' rate, the larger."""
    return max(bytes_of(kind, m, k, n) / HBM, 2.0 * m * k * n / PEAK_BF16) * 1e3


def dequantized(kind: str, wt):
    """The weight as bf16 (K, N) from its int8 or int4 form and scales (the
    bf16 reference's operand; it rounds w * scale to bf16)."""
    if kind == "int8":
        return (wt[0].float() * wt[1][:, None]).bfloat16().T.contiguous()
    w = i4m.unpack_int4(wt[0]).float()
    return (w * wt[1].repeat_interleave(128, dim=0).T).bfloat16().T.contiguous()


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


def checks(kern: dict, proj: dict) -> None:
    """Each version against the plain versions, relaunched and row by row,
    its GEMV outputs against base's bits. A version whose launch fails is
    reported and dropped."""
    first = {}
    for name, mods in list(kern.items()):
        try:
            check_version(name, mods, proj, first)
        except RuntimeError as exc:
            print(f"{name:>10}: {exc}; dropped", flush=True)
            del kern[name]


def check_version(name: str, mods: dict, proj: dict, first: dict) -> None:
    activate(mods)
    bad, gemv = [], []
    for label, p in proj.items():
        k = p["k"]
        x8 = torch.randn((8, k), generator=torch.Generator("cuda").manual_seed(k),
                         device="cuda").bfloat16()
        for kind in ("int8", "int4"):
            for gain in ([None, p["gain"]] if kind == "int4" else [None]):
                wt = p[kind][0]
                outs = {m: run(kind, x8[:m], wt, gain, torch.float32) for m in ROWS}
                gemv += [outs[m] for m in ROWS] + [run(kind, x8[:4], wt, gain, torch.bfloat16)]
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
    if first:
        eq = [torch.equal(a, b) for a, b in zip(gemv, first["base"])]
        print(f"{name:>10}: GEMV outputs (every projection, M = 1, 4, 8 in float32 and M = 4 "
              f"in bf16; int8, int4, int4 with the prologue) bit-equal to base in "
              f"{sum(eq)}/{len(eq)}", flush=True)
    else:
        first["base"] = gemv
    print(f"{name:>10}: GEMV checks (plain within quant_close, relaunch, row invariance at "
          f"M = 1, 4, 8): {'all passed' if not bad else 'FAILED ' + '; '.join(bad)}",
          flush=True)

    bad, rows_same, n_rows, gemm = [], 0, 0, []
    for m, k, n in GEMM_CASES:
        gg = torch.Generator("cuda").manual_seed(m)
        x = torch.randn((m, k), generator=gg, device="cuda")
        w = (torch.randn((n, k), generator=gg, device="cuda") * 0.03).bfloat16()
        w_int, sc = i4m.quantize_weight_int4(w, 128)
        wts = {"int8": i8m.quantize_weight_int8(w), "int4": (i4m.pack_int4(w_int), sc)}
        gain = 1 + 0.1 * torch.randn((k,), generator=gg, device="cuda")
        for kind in ("int8", "int4"):
            for gn in ([None, gain] if kind == "int4" else [None]):
                for xx in (x, x.bfloat16()):
                    case = f"{kind} M={m} K={k} N={n} prologue={gn is not None} x {xx.dtype}"
                    out = run(kind, xx, wts[kind], gn, torch.float32)
                    ok, detail = quant_close(out, plain(kind, xx, wts[kind], gn), gn is not None)
                    if not ok:
                        bad.append(f"{case}: {detail}")
                    for dt in (torch.float32, torch.bfloat16):
                        ref = out if dt == torch.float32 else run(kind, xx, wts[kind], gn, dt)
                        gemm.append(ref)
                        if not torch.equal(run(kind, xx, wts[kind], gn, dt), ref):
                            bad.append(f"{case} {dt}: a relaunch differs")
                        if m > ROW_M:
                            n_rows += 1
                            rows_same += torch.equal(run(kind, xx[:ROW_M], wts[kind], gn, dt),
                                                     ref[:ROW_M])
    if "gemm" in first:
        eq = [torch.equal(a, b) for a, b in zip(gemm, first["gemm"])]
        print(f"{name:>10}: GEMM outputs (every case above, float32 and bf16) bit-equal to "
              f"base in {sum(eq)}/{len(eq)}", flush=True)
    else:
        first["gemm"] = gemm
    print(f"{name:>10}: GEMM checks (M, K, N in {GEMM_CASES}; int8, int4, int4 with the "
          f"prologue; f32 and bf16 x and output; plain within quant_close, relaunch "
          f"bit-equal): {'all passed' if not bad else 'FAILED ' + '; '.join(bad)}; rows "
          f"0..{ROW_M - 1} at M = {ROW_M} bit-equal to the same rows at the full M in "
          f"{rows_same}/{n_rows}", flush=True)
    torch.cuda.synchronize()


def gemm_cases(g) -> list:
    """(case name, kind, x, weight, gain) of every GEMM timing: the FM's
    projections at FM_ROWS, the AR prefill's at PREFILL_ROWS, int4 also
    with the prologue on qkv and gateup (one weight per shape)."""
    out = []
    for rows, tag, shapes in ((FM_ROWS, "FM", FM_PROJ), (PREFILL_ROWS, "prefill", AR_PROJ)):
        for label, (k, n) in zip(LABELS, shapes):
            x = torch.randn((rows, k), generator=g, device="cuda").bfloat16()
            w = (torch.randn((n, k), generator=g, device="cuda") * 0.03).bfloat16()
            w_int, sc = i4m.quantize_weight_int4(w, 128)
            wts = {"int8": i8m.quantize_weight_int8(w), "int4": (i4m.pack_int4(w_int), sc)}
            for kind in ("int8", "int4"):
                out.append((f"{kind} GEMM {tag} {label} ({rows}, {k}) -> {n}", kind, x,
                            wts[kind], None))
            if tag == "prefill" and label in PROLOGUE:
                gain = 1 + 0.1 * torch.randn((k,), generator=g, device="cuda")
                out.append((f"int4+rms GEMM {tag} {label} ({rows}, {k}) -> {n}", "int4", x,
                            wts["int4"], gain))
    return out


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
        checks(kern, proj)
        xs = {m: {k: torch.randn((m, k), generator=g, device="cuda").bfloat16()
                  for k in {p["k"] for p in proj.values()}} for m in ROWS}
        gemms = gemm_cases(g)

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
            for case, kind, x, w, gn in gemms:
                yield case, kind, [(x, w, gn)]

        times = {}
        for name in list(kern) + list(kern)[::-1]:
            activate(kern[name])
            for case, kind, calls in cases():
                ms = graph_ms(lambda: [run(kind, x, w, gn) for x, w, gn in calls])
                times.setdefault(case, {}).setdefault(name, []).append(ms)
        rows = []
        for case, kind, calls in cases():
            gemm = "GEMM" in case
            per_call = "step" not in case and not gemm
            div = len(calls) if per_call else 1
            unit, f = ("us", 1e3) if per_call else ("ms", 1.0)
            m = calls[0][0].shape[0]
            bound = sum(bound_ms(kind, m, x.shape[1], w[0].shape[0]) for x, w, _ in calls) / div * f
            lib = ref = None
            if all(gn is None for _, _, gn in calls):
                by_w = {}
                for x, w, _ in calls:
                    by_w.setdefault(x.shape[1], []).append(w)
                fns = [library(kind, ws, next(x for x, w, _ in calls if x.shape[1] == k))
                       for k, ws in by_w.items()]
                if all(fns):
                    lib = graph_ms(lambda: [fn() for fn in fns]) / div * f
            if gemm and calls[0][2] is None:
                x, w, _ = calls[0]
                wd = dequantized(kind, w)
                ref = graph_ms(lambda: torch.matmul(x, wd))
            row = {"case": case, "bound_" + unit: bound, "library_" + unit: lib,
                   **({"bf16_matmul_reference_ms": ref} if gemm else {}),
                   **{f"{n}_{unit}": [t / div * f for t in ts] for n, ts in times[case].items()}}
            rows.append(row)
            print(f"{case:>52}: " + "  ".join(
                f"{n} " + " ".join(f"{t / div * f:.4f}" for t in ts)
                for n, ts in times[case].items())
                + f"  | bound {bound:.4f}"
                + (f", library {lib:.4f}" if lib is not None else ", library none")
                + (f", bf16 matmul reference {ref:.4f}" if ref is not None else "") + f" {unit}",
                flush=True)
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps({"card": nvidia_smi(), "rows": rows}, indent=1))
        procs = [(kernel(m), subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / f"{kernel(m).name}_v.so"), str(kernel(m).source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for mods in kern.values() for m in mods.values()]
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
