"""Build the CUDA kernels under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C functions (pointers, ints, a
stream) and compiles on its own into ``build/<name>-<hash>.so`` beside this
file, the hash covering the source, the shared ``csrc/*.cuh`` headers and
the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.

A `Kernel` owns one library. Its ``launch`` calls a C function, raises if
the function reports a CUDA error, and counts the launch: the count is how
a run shows that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH, or
    ``/usr/local/cuda/bin/nvcc``. Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class Kernel:
    """One ``csrc/<name>.cu`` library, built on first use."""

    def __init__(self, name: str, signatures: dict[str, list]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.signatures = signatures  # C function → ctypes argtypes
        self.launches = 0
        self.tagged = {}  # launches of a named variant or path (a fused prologue, the GEMM)
        self._lib = None
        self._lock = threading.Lock()

    def _target(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):  # shared headers
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD / f"{self.name}-{h.hexdigest()[:16]}.so"

    def compile_process(self) -> tuple | None:
        """Start ``nvcc`` for this source unless its library exists;
        returns (process, temporary output, library path)."""
        target = self._target()
        if target.exists():
            return None
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, target

    @staticmethod
    def finish(job: tuple | None, timeout: float = 600) -> None:
        """Wait for a `compile_process` job and move its library in place."""
        if job is None:
            return
        proc, tmp, target = job
        try:
            out, _ = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out}")
        os.replace(tmp, target)

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.finish(self.compile_process())
                lib = ctypes.CDLL(str(self._target()))
                for fn, argtypes in self.signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def launch(self, fn: str, *args, tag: str | tuple | None = None) -> None:
        """Call C function ``fn`` (which launches on the given stream and
        returns ``cudaGetLastError()``), raise on an error, count it (and
        under ``tag``, or each of a tuple of tags, when it runs a named
        variant or path)."""
        rc = getattr(self.lib(), fn)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {rc}")
        with self._lock:
            self.launches += 1
            for t in (tag,) if isinstance(tag, str) else tag or ():
                self.tagged[t] = self.tagged.get(t, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.tagged = {}


def no_backward(name: str, *tensors) -> None:
    """Raise when autograd would need a gradient through kernel ``name``,
    which has no backward: a CUDA kernel's output has no ``grad_fn``, so it
    would silently cut the graph. Called by the wrappers of kernels that JAX
    does not differentiate either (on a CUDA tensor only; their plain
    versions on the CPU are differentiated by autograd)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: call it under torch.no_grad() "
                           "or on inputs that do not require grad")


def build_all(kernels: list[Kernel]) -> None:
    """Compile every kernel's source at once (one ``nvcc`` each), then load."""
    jobs = [k.compile_process() for k in kernels]
    for job in jobs:
        Kernel.finish(job)
    for k in kernels:
        k.lib()


P = ctypes.c_void_p
I = ctypes.c_int
Fl = ctypes.c_float
