#!/usr/bin/env python3
"""Build versions of the decode-attention (#8) and anti-aliased SnakeBeta (#2) kernels side by side and time them in turns.

Each argument is a directory holding another version of
``decode_attn_int8.cu`` and ``aa_snake.cu`` with the headers they include,
for instance the parent commit's ``csrc`` files from ``git show`` in an
ignored directory, and, where that version's C interface differs from the
repository's, its wrappers ``decode_attention.py`` and ``aa_snake.py``; the
repository's own ``amphion_tpu_torch/ops/kernels`` is always the first
version, "base". Each version is built under its own name (one nvcc per
source, all at once) and called through its own wrappers. Then, on one
card, with random inputs from a fixed seed:

- #8 against its plain version within 1e-4 of max|ref| and relaunched bit
  for bit, at the fused single-utterance decode's cache (1, 20, 1272, 64)
  at each ``--lens`` valid length, at B = 4 with ragged lengths and at
  D = 128; and whether its outputs equal base's;
- #2 against its plain version, bit for bit in float32 and within one bf16
  step in bf16, at the five shapes of a 10 s file's activations and a
  ragged one; and whether its outputs equal base's;
- each version timed by CUDA-graph replays (``chip_smoke.graph_ms``) in the
  order base, v1, ..., vn, vn, ..., base: #8 per call at each valid length,
  as one decode step runs it (24 calls on 24 layers' caches, which stream
  from device memory) and on one cache called 24 times (L2-resident); #2
  per launch at each shape of the file and their mean weighted by the
  file's launches (18 at each stage's shape, 19 at the last), beside each
  one's bound;
- each version's registers and spills (``nvcc -Xptxas -v``).

Run from the repository root on a machine with a card (``--json PATH``
also writes every timing row, with the card's name, to PATH):

    python3 tools/kernel_ab.py [DIR ...] [--lens 505 888 1272] [--json PATH]
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
from chip_smoke import (AA_OPS, AR_HEADS, AR_LAYERS, HBM, PEAK_F32, _bound,  # noqa: E402
                        graph_ms, nvidia_smi, within_bf16_step)

D, S = 64, 1272  # the fused single-utterance decode's head dim and cache length
# (B, T, C) of a 10 s file's kernel-2 launches at batch 1 and their counts
AA_SHAPES = {(1, 10000, 256): 18, (1, 40000, 128): 18, (1, 120000, 64): 18,
             (1, 240000, 32): 19}
AA_EXTRA = [(2, 5001, 48), (1, 12, 40)]  # a partial last run, C in 33-63; T < 13
KERNELS = {"decode": ("decode_attn_int8", "decode_attention", "DECODE_ATTN", dam),
           "aa": ("aa_snake", "aa_snake", "AA_SNAKE", aam)}


def wrapper(py: Path, name: str):
    """A version's wrapper module, loaded under a name of its own so that
    its kernel can be swapped."""
    spec = importlib.util.spec_from_file_location(f"kernel_ab_{name}_{py.stem}", py)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def versions(dirs: list[str], scratch: Path) -> dict:
    """name → {"decode": wrapper module, "aa": wrapper module}, each with
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
        for key, (stem, py_stem, attr, repo_mod) in KERNELS.items():
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


def checks(kern: dict, lens: list) -> None:
    """Each version against the plain versions and relaunched, its outputs
    against base's bits. A version whose launch fails is dropped."""
    g = torch.Generator("cuda").manual_seed(1)
    dec_cases = [(1, AR_HEADS, S, D, [n]) for n in lens] + [
        (4, AR_HEADS, 1600, D, [1600, 1201, 256, 1]), (2, 8, 300, 128, [300, 257])]
    dec = [(c, decode_inputs(g, *c)) for c in dec_cases]
    aa = [(shape, aa_inputs(g, shape)) for shape in list(AA_SHAPES) + AA_EXTRA]
    base = {}
    for name, mods in list(kern.items()):
        bad, outs = [], []
        try:
            for case, args in dec:
                out = mods["decode"].decode_attention_int8(*args)
                ref = dam.decode_attention_int8_ref(*args)
                err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
                same = torch.equal(mods["decode"].decode_attention_int8(*args), out)
                if not (err <= 1e-4 * scale and same):
                    bad.append(f"#8 {case}: max|err| {err:.3g} (tol 1e-4 of {scale:.3g}), "
                               f"relaunch bit-equal {same}")
                outs.append(out)
            for shape, (x, alpha, beta) in aa:
                out = mods["aa"].aa_snakebeta(x, alpha, beta)
                ref = aam.aa_snakebeta_ref(x, alpha, beta)
                if not torch.equal(out, ref):
                    bad.append(f"#2 {shape} float32: max|err| "
                               f"{(out - ref).abs().max().item():.3g} (want bit-equal)")
                ok, detail = within_bf16_step(mods["aa"].aa_snakebeta(x.bfloat16(), alpha, beta),
                                              aam.aa_snakebeta_ref(x.bfloat16(), alpha, beta))
                if not ok:
                    bad.append(f"#2 {shape} bf16: {detail}")
                outs.append(out)
            torch.cuda.synchronize()
        except RuntimeError as exc:
            print(f"{name:>10}: {exc}; dropped", flush=True)
            del kern[name]
            continue
        if base:
            eq = [torch.equal(a, b) for a, b in zip(outs, base["base"])]
            print(f"{name:>10}: outputs bit-equal to base in {sum(eq)}/{len(eq)} cases",
                  flush=True)
        else:
            base["base"] = outs
        print(f"{name:>10}: #8 within 1e-4 and relaunch bit-equal at {len(dec)} cases, #2 "
              f"bit-equal (f32) and within one bf16 step at {len(aa)} shapes: "
              f"{'all passed' if not bad else 'FAILED ' + '; '.join(bad)}", flush=True)


def decode_bound(valid: int) -> float:
    """Bytes over the memory rate (K, V rows and scales up to valid, q, out)
    or operations over the bf16 rate, the larger, in ms."""
    return _bound(4.0 * AR_HEADS * valid * D, AR_HEADS * valid * (2 * D + 8)
                  + 8 * AR_HEADS * D + 4)[0]


def aa_bound(shape) -> float:
    n = shape[0] * shape[1] * shape[2]
    return max(AA_OPS * n / PEAK_F32, (8.0 * n + 8 * shape[2] + 112) / HBM) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="*", help="directories holding other versions")
    ap.add_argument("--lens", type=int, nargs="+", default=[505, 888, 1272],
                    help="#8's valid lengths: the fused run's first, middle and last steps")
    ap.add_argument("--json", help="write the timing rows here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        kern = versions(args.dirs, Path(tmp))
        card = nvidia_smi()
        print(card, flush=True)
        checks(kern, args.lens)
        g = torch.Generator("cuda").manual_seed(2)
        layers = {n: [decode_inputs(g, 1, AR_HEADS, S, D, [n]) for _ in range(AR_LAYERS)]
                  for n in args.lens}
        aa = {shape: aa_inputs(g, shape) for shape in AA_SHAPES}

        def cases():
            """(case, kind, calls per replay, a function of the wrapper
            modules that runs them, bound ms per call)."""
            for n, calls in layers.items():
                yield (f"#8 valid_len {n}, one step (24 caches)", AR_LAYERS,
                       lambda mods, calls=calls: [mods["decode"].decode_attention_int8(*c)
                                                  for c in calls], decode_bound(n))
                yield (f"#8 valid_len {n}, one cache x 24", AR_LAYERS,
                       lambda mods, c=calls[0]: [mods["decode"].decode_attention_int8(*c)
                                                 for _ in range(AR_LAYERS)], decode_bound(n))
            for shape, xab in aa.items():
                yield (f"#2 {shape}", 1, lambda mods, xab=xab: mods["aa"].aa_snakebeta(*xab),
                       aa_bound(shape))

        times = {}
        with torch.no_grad():
            for name in list(kern) + list(kern)[::-1]:
                for case, n, fn, _ in cases():
                    ms = graph_ms(lambda: fn(kern[name])) / n
                    times.setdefault(case, {}).setdefault(name, []).append(ms)
        rows = []
        for case, _, _, bound in cases():
            rows.append({"case": case, "bound_ms": bound,
                         **{f"{n}_ms": ts for n, ts in times[case].items()}})
            print(f"{case:>44}: " + "  ".join(f"{n} " + " ".join(f"{t * 1e3:.3f}" for t in ts)
                                              for n, ts in times[case].items())
                  + f"  | bound {bound * 1e3:.3f} us", flush=True)
        w = sum(AA_SHAPES.values())
        mean = {"case": "#2 mean per launch over a 10 s file's 73",
                "bound_ms": sum(aa_bound(s) * c for s, c in AA_SHAPES.items()) / w}
        for name in kern:
            mean[f"{name}_ms"] = [sum(times[f"#2 {s}"][name][i] * c for s, c in AA_SHAPES.items())
                                  / w for i in range(2)]
        rows.append(mean)
        print(f"{mean['case']:>44}: " + "  ".join(
            f"{n} " + " ".join(f"{t * 1e3:.3f}" for t in mean[f'{n}_ms']) for n in kern)
            + f"  | bound {mean['bound_ms'] * 1e3:.3f} us", flush=True)
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
