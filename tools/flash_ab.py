#!/usr/bin/env python3
"""Build versions of the flash-attention kernels side by side and time them in turns.

Each argument is a directory holding another version of
``flash_attn_fwd.cu`` (and optionally ``flash_attn_bwd.cu``) with the
headers they include, for instance an older tree unpacked by ``git
archive``; the repository's own ``amphion_tpu_torch/ops/kernels/csrc`` is
always the first version, "base". Each version is built under its own name
(one nvcc per source, all at once) and swapped into the wrapper
(`flash_attention` and `flash_attention_bwd`). Then, on one card:

- each version against the plain versions at the timbre serving shape
  (4, 1536, 16, 64) bf16 with a key mask, and at the FM (8, 256, 16, 64)
  and AR (8, 516, 20, 64, causal, ragged mask) training shapes in float32,
  forward and backward, and whether its outputs equal base's bit for bit;
- each version timed by CUDA-graph replays (``chip_smoke.graph_ms``) in the
  order base, v1, ..., vn, vn, ..., base, beside SDPA at the same shapes;
- base's backward under torch.profiler (device time by kernel) and its
  registers and spills (``nvcc -Xptxas -v``).

Run from the repository root on a machine with a card:

    python3 tools/flash_ab.py [DIR ...]
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from amphion_tpu_torch.ops.kernels import _build  # noqa: E402
from amphion_tpu_torch.ops.kernels import flash_attention as fm  # noqa: E402
from chip_smoke import device_us_by_name, graph_ms, nvidia_smi  # noqa: E402

SOURCES = (("flash_attn_fwd", fm.FLASH), ("flash_attn_bwd", fm.FLASH_BWD))


def versions(dirs: list[str], scratch: Path) -> dict:
    """name → [forward Kernel, backward Kernel or None], each source copied
    with its headers under a name of its own (the build hash covers the
    source and the repository's headers, not a copy's)."""
    out = {}
    for name, src_dir in [("base", _build.CSRC)] + [(Path(d).name, Path(d)) for d in dirs]:
        dst = scratch / name
        dst.mkdir(parents=True)
        for f in list(src_dir.glob("*.cuh")) + list(src_dir.glob("flash_attn_*.cu")):
            shutil.copy(f, dst / f.name)
        pair = []
        for stem, ref in SOURCES:
            if not (dst / f"{stem}.cu").exists():
                pair.append(None)
                continue
            shutil.copy(dst / f"{stem}.cu", dst / f"{stem}_{name}.cu")
            k = _build.Kernel(f"{stem}_{name}", ref.signatures)
            k.source = dst / f"{stem}_{name}.cu"
            pair.append(k)
        out[name] = pair
    t0 = time.time()
    jobs = {k.name: k.compile_process() for pair in out.values() for k in pair if k}
    for name in list(out):
        try:
            for k in filter(None, out[name]):
                _build.Kernel.finish(jobs[k.name])
                k.lib()
        except RuntimeError as exc:
            print(f"{name} does not build:\n{str(exc)[:3000]}", flush=True)
            del out[name]
    print(f"built {len(out)} versions in {time.time() - t0:.1f} s", flush=True)
    return out


def cases() -> dict:
    dev = "cuda"
    g = torch.Generator(dev).manual_seed(0)
    out = {}
    b, L, h, d = 4, 1536, 16, 64
    q, k, v = (torch.randn((b, L, h, d), generator=g, device=dev).bfloat16() for _ in range(3))
    valid = torch.tensor([1536, 1530, 1533, 1536], device=dev)
    out["bf16 timbre"] = (q, k, v, (torch.arange(L, device=dev)[None] < valid[:, None]).float(),
                          None, False)
    for name, (b, L, h, causal) in {"f32 fm": (8, 256, 16, False),
                                    "f32 ar": (8, 516, 20, True)}.items():
        q, k, v, do = (torch.randn((b, L, h, 64), generator=g, device=dev) for _ in range(4))
        valid = torch.tensor([L - (37 * i if causal else 0) for i in range(b)], device=dev)
        out[name] = (q, k, v, (torch.arange(L, device=dev)[None] < valid[:, None]).float(),
                     do, causal)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        kern = versions(sys.argv[1:], Path(tmp))
    print(nvidia_smi(), flush=True)
    data = cases()

    def use(name):
        fm.FLASH = kern[name][0]
        fm.FLASH_BWD = kern[name][1] or kern["base"][1]

    first = {}
    for name in kern:
        use(name)
        for cname, (q, k, v, mask, do, causal) in data.items():
            o, lse = fm.flash_attention(q, k, v, mask, causal, return_lse=True)
            res = [o, lse]
            line = (f"{name:>12} {cname}: forward max|err| "
                    f"{(o.float() - fm.attention_ref(q, k, v, mask, causal).float()).abs().max().item():.3g}")
            if do is not None:
                res += list(fm.flash_attention_bwd(q, k, v, mask, o, lse, do, causal))
                refs = fm.flash_attention_bwd_ref(q, k, v, mask, o, lse, do, causal)
                line += ", backward max|err|/max|ref| " + " ".join(
                    f"{(a - r).abs().max().item() / r.abs().max().item():.3g}"
                    for a, r in zip(res[2:], refs))
            if cname in first:
                line += f"; equal to base: {[torch.equal(a, b) for a, b in zip(res, first[cname])]}"
            else:
                first[cname] = res
            print(line, flush=True)

    times = {}
    for name in list(kern) + list(kern)[::-1]:
        use(name)
        for cname, (q, k, v, mask, do, causal) in data.items():
            times.setdefault((cname, "forward", name), []).append(graph_ms(
                lambda: fm.flash_attention(q, k, v, mask, causal, return_lse=do is not None)))
            if do is not None:
                o, lse = fm.flash_attention(q, k, v, mask, causal, return_lse=True)
                times.setdefault((cname, "backward", name), []).append(graph_ms(
                    lambda: fm.flash_attention_bwd(q, k, v, mask, o, lse, do, causal)))
    for (cname, what, name), ts in sorted(times.items()):
        print(f"{cname:>12} {what:>8} {name:>12}: " + " ".join(f"{t:.5f}" for t in ts) + " ms")
    for cname, (q, k, v, mask, do, causal) in data.items():
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if do is None:  # the serving call: a (B, 1, 1, Lk) key mask
            m = (mask > 0)[:, None, None, :]
        else:
            b, L = q.shape[:2]
            m = (mask > 0)[:, None, :].expand(b, L, L)
            if causal:
                m = m & torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
            m = m[:, None]
        print(f"SDPA {cname} forward "
              f"{graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m)):.5f} ms")

    from torch.profiler import ProfilerActivity, profile

    use("base")
    for cname in ("f32 fm", "f32 ar"):
        q, k, v, mask, do, causal = data[cname]
        o, lse = fm.flash_attention(q, k, v, mask, causal, return_lse=True)
        for _ in range(3):
            fm.flash_attention_bwd(q, k, v, mask, o, lse, do, causal)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fm.flash_attention_bwd(q, k, v, mask, o, lse, do, causal)
            torch.cuda.synchronize()
        by_name, _ = device_us_by_name(prof)
        print(f"{cname} backward, device µs per call by kernel: " + ", ".join(
            f"{n[:60]} {us / 10:.2f}" for n, us in sorted(by_name.items(), key=lambda x: -x[1])))
    for stem, _ in SOURCES:
        r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                            str(Path(tempfile.gettempdir()) / f"{stem}_ab.so"),
                            str(_build.CSRC / f"{stem}.cu")], capture_output=True, text=True)
        cur = ""
        for line in (r.stdout + r.stderr).splitlines():
            if "Compiling entry function" in line:
                cur = line.split("'")[1][:60]
            elif "registers" in line or "spill" in line:
                print(f"{stem} {cur}: {line.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
