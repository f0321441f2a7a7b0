"""Poisson open-loop load generator for the serving layer (the port's own
copy of `amphion_tpu/serving/loadgen.py`, pure stdlib and numpy).

Drives a service's ``submit``-style callable with exponentially
distributed inter-arrival times at a target QPS (an OPEN loop: arrivals
don't wait for completions, so queueing delay shows up in the tail —
the methodology behind latency-vs-load curves; a closed loop of N
workers would hide it). Collects per-request end-to-end latency and
reports p50/p95/p99.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from amphion_tpu_torch.serving.batcher import _percentile


@dataclass
class LoadResult:
    qps_target: float
    qps_achieved: float
    n_sent: int
    n_ok: int
    n_err: int
    latency_ms_p50: float
    latency_ms_p95: float
    latency_ms_p99: float
    latency_ms_mean: float
    lat_ms: list | None = None  # raw per-request latencies (sorted)

    def row(self) -> dict:
        return {
            "qps_target": round(self.qps_target, 3),
            "qps_achieved": round(self.qps_achieved, 3),
            "n": self.n_sent, "ok": self.n_ok, "err": self.n_err,
            "p50_ms": round(self.latency_ms_p50, 1),
            "p95_ms": round(self.latency_ms_p95, 1),
            "p99_ms": round(self.latency_ms_p99, 1),
            "mean_ms": round(self.latency_ms_mean, 1),
        }


def run_load(submit, make_request, qps: float, duration_s: float,
             seed: int = 0, drain_timeout_s: float = 120.0) -> LoadResult:
    """Open-loop Poisson drive.

    submit: callable(payload) -> concurrent.futures.Future (e.g. a
        service method wrapped to return the batcher future) OR a
        blocking callable (run in a thread per request).
    make_request: (i) -> payload for the i-th request.
    """
    rng = np.random.default_rng(seed)
    lat_ms: list[float] = []
    errs: list[int] = []
    lock = threading.Lock()
    threads: list[threading.Thread] = []

    def fire(i, payload):
        t0 = time.monotonic()
        try:
            out = submit(payload)
            if hasattr(out, "result"):
                out.result(timeout=drain_timeout_s)
            ok = True
        except Exception:
            ok = False
        dt = (time.monotonic() - t0) * 1e3
        with lock:
            if ok:
                lat_ms.append(dt)
            else:
                errs.append(i)

    t_start = time.monotonic()
    deadline = t_start + duration_s
    i = 0
    next_t = t_start
    while next_t < deadline:
        now = time.monotonic()
        if now < next_t:
            time.sleep(next_t - now)
        th = threading.Thread(target=fire, args=(i, make_request(i)),
                              daemon=True)
        th.start()
        threads.append(th)
        i += 1
        next_t += float(rng.exponential(1.0 / qps))
    for th in threads:
        th.join(timeout=drain_timeout_s)
    wall = time.monotonic() - t_start
    lats = sorted(lat_ms)
    return LoadResult(
        qps_target=qps, qps_achieved=len(lat_ms) / max(wall, 1e-9),
        n_sent=i, n_ok=len(lat_ms), n_err=len(errs),
        latency_ms_p50=_percentile(lats, 50),
        latency_ms_p95=_percentile(lats, 95),
        latency_ms_p99=_percentile(lats, 99),
        latency_ms_mean=float(np.mean(lats)) if lats else 0.0,
        lat_ms=lats,
    )


def poisson_arrivals(qps: float, n: int, seed: int = 0) -> np.ndarray:
    """Fixed n-request Poisson arrival trace (seconds from t=0).

    Precomputing the trace lets two dispatchers (continuous vs window)
    be driven with IDENTICAL arrival schedules."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / qps, size=n))


def run_trace(submit, make_request, arrivals,
              drain_timeout_s: float = 600.0) -> LoadResult:
    """Open-loop drive of a FIXED arrival trace (`poisson_arrivals`).

    Same semantics as `run_load` but over exactly ``len(arrivals)``
    requests at predetermined times — so different services can be
    compared on the same schedule. ``submit`` is a blocking callable
    (each request fires on its own thread)."""
    arrivals = np.asarray(arrivals, np.float64)
    lat_ms: list[float] = []
    errs: list[int] = []
    lock = threading.Lock()

    def fire(i, payload):
        t0 = time.monotonic()
        try:
            out = submit(payload)
            if hasattr(out, "result"):
                out.result(timeout=drain_timeout_s)
            ok = True
        except Exception:
            ok = False
        dt = (time.monotonic() - t0) * 1e3
        with lock:
            if ok:
                lat_ms.append(dt)
            else:
                errs.append(i)

    threads = []
    t_start = time.monotonic()
    for i, at in enumerate(arrivals):
        now = time.monotonic() - t_start
        if now < at:
            time.sleep(at - now)
        th = threading.Thread(target=fire, args=(i, make_request(i)),
                              daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=drain_timeout_s)
    wall = time.monotonic() - t_start
    lats = sorted(lat_ms)
    qps = len(arrivals) / max(float(arrivals[-1]), 1e-9)
    return LoadResult(
        qps_target=qps, qps_achieved=len(lat_ms) / max(wall, 1e-9),
        n_sent=len(arrivals), n_ok=len(lat_ms), n_err=len(errs),
        latency_ms_p50=_percentile(lats, 50),
        latency_ms_p95=_percentile(lats, 95),
        latency_ms_p99=_percentile(lats, 99),
        latency_ms_mean=float(np.mean(lats)) if lats else 0.0,
        lat_ms=lats,
    )


def http_synthesize_submit(url: str, timeout_s: float = 600.0):
    """Blocking submit callable for `run_load`/`run_trace` that POSTs a
    JSON payload to ``{url}/api/synthesize`` (the `bins/serve.py`
    schema) and returns the response bytes. Raises on non-200."""
    import json
    import urllib.request

    def submit(payload: dict) -> bytes:
        req = urllib.request.Request(
            url.rstrip("/") + "/api/synthesize",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            if r.status != 200:
                raise RuntimeError(f"HTTP {r.status}")
            return r.read()

    return submit
