"""Continuous-batching serving of the AR backends (port of
`amphion_tpu/serving/continuous_service.py`: `EngineDriver`,
`VevoContinuousService`, `ValleContinuousService`). `bins/serve.py
--batcher continuous`, the default for the vevo and valle backends, builds
them instead of the window `VevoService` and `VALLEService`.

- `EngineDriver` owns a continuous engine (`serving/continuous.py`) on one
  background thread and offers a blocking `submit_wait` that any number of
  HTTP handler threads call at once. A request joins the live decode at the
  next chunk boundary: no wait window, no drain.
- `VevoContinuousService` subclasses the window service and replaces only
  its dispatch: the shared front end (`_prepare_request`) feeds the engine
  for the AR stage, and the flow matching and Vocos run per finished
  request (`_fm_tail`), with the generators of the window path, so a
  request's tokens and waveform are those the window service gives it.
- `ValleContinuousService` does the same for VALL-E: the engine
  (`ContinuousValleBatcher`) runs the AR stage, and the greedy NAR and the
  codec decode run per finished request at the window service's buckets.
- The solo path: when the engine is idle, one request is pending and the
  service has no other request in flight (``solo_gate``), the driver runs
  the request's one-shot ragged decode instead. It declines (returns
  None) when the engine replays CUDA graphs, whose one-row rung is the
  cheaper one-shot program on the card; it is taken where the engine runs
  eagerly. An exception from it reaches the caller.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time

import numpy as np
import torch

from amphion_tpu_torch.models.tts.valle.valle import ar_generate_ragged
from amphion_tpu_torch.models.vc.ar_transformer import ar_transformer_generate_ragged
from amphion_tpu_torch.serving.continuous import ContinuousARBatcher, ContinuousValleBatcher
from amphion_tpu_torch.serving.service import (
    VALLEService,
    VevoService,
    _pad_to,
    _ValleCoreRequest,
    _VevoCoreRequest,
    voice_generators,
)


def _ladder_tuple(step: int, cap: int) -> tuple[int, ...]:
    """Bucket ladder as an explicit tuple: step, 2*step, ..., cap."""
    rungs = list(range(step, cap, step)) + [cap]
    return tuple(sorted(set(rungs)))


class EngineDriver:
    """Thread-safe blocking facade over a continuous engine.

    `submit_wait(*engine_submit_args)` enqueues into the engine (on the
    driver thread, at the next chunk boundary) and blocks the calling
    thread until that request's tokens are ready. Errors raised by the
    engine's `submit` (an over-long prompt, the capacity) or by the solo
    path reach the caller; an error inside a chunk fails every waiting
    request and stops the driver. `stats()` is cheap and safe from any
    thread.
    """

    def __init__(self, engine: ContinuousARBatcher, solo_fn=None, solo_gate=None):
        self.engine = engine
        # solo_gate: a further host-side condition for the solo path (the
        # service passes "no other request in flight"), so that steady
        # light load is not served as back-to-back solos
        self.solo_gate = solo_gate
        self.solo_fn = solo_fn
        self.solo_enabled = solo_fn is not None
        self._solo_served = 0
        self._cv = threading.Condition()
        self._inbox: list[tuple[tuple, dict, dict]] = []
        self._waiters: dict[int, dict] = {}
        self._latencies: list[float] = []
        self._stop = False
        self._admitted = 0
        self._chunks = 0
        self._occ_sum = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="continuous-engine")
        self._thread.start()

    def submit_wait(self, *args, timeout: float | None = None, **kw) -> torch.Tensor:
        box: dict = {"ev": threading.Event(), "t0": time.perf_counter()}
        with self._cv:
            if self._stop:
                raise RuntimeError("engine driver is shut down")
            self._inbox.append((args, kw, box))
            self._cv.notify()
        if not box["ev"].wait(timeout):
            raise TimeoutError("request timed out in the continuous engine")
        if "error" in box:
            raise box["error"]
        return box["tokens"]

    def shutdown(self, wait: bool = True) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        if wait:
            self._thread.join(timeout=60)

    def _busy(self) -> bool:
        e = self.engine
        return bool(e.queue) or any(s.req is not None for s in e.slots)

    def _fail_all(self, err: BaseException) -> None:
        with self._cv:
            boxes = [box for _, _, box in self._inbox] + list(self._waiters.values())
            self._inbox, self._waiters = [], {}
        for box in boxes:
            box["error"] = err
            box["ev"].set()

    def _record(self, box: dict, tokens, latency: float) -> None:
        with self._cv:
            self._latencies.append(latency)
            del self._latencies[:-4096]  # bounded history
        box["tokens"] = tokens
        box["ev"].set()

    def _loop(self) -> None:
        e = self.engine
        while True:
            with self._cv:
                while not self._inbox and not self._busy() and not self._stop:
                    self._cv.wait()
                if self._stop:
                    break
                pending, self._inbox = self._inbox, []
            if (self.solo_enabled and len(pending) == 1 and not self._waiters
                    and not self._busy() and (self.solo_gate is None or self.solo_gate())):
                args, kw, box = pending[0]
                try:
                    toks = self.solo_fn(*args, **kw)
                except Exception as exc:  # the caller gets it; the driver goes on
                    box["error"] = exc
                    box["ev"].set()
                    continue
                if toks is not None:
                    self._solo_served += 1
                    self._record(box, toks, time.perf_counter() - box["t0"])
                    continue
            for args, kw, box in pending:
                try:
                    rid = e.submit(*args, **kw)
                except (ValueError, TypeError) as exc:  # over-long prompt, capacity
                    box["error"] = exc
                    box["ev"].set()
                    continue
                self._waiters[rid] = box
                self._admitted += 1
            if not self._busy():
                continue
            try:
                finished = e.step_chunk()
            except Exception as exc:  # the engine's state is unknown: fail and stop
                self._stop = True
                self._fail_all(exc)
                raise
            self._chunks += 1
            self._occ_sum += sum(s.req is not None for s in e.slots) + len(finished)
            for rid in finished:
                box = self._waiters.pop(rid, None)
                tokens = e.completed.pop(rid, None)
                lat = e.latency_s.pop(rid, 0.0)
                if box is not None:
                    self._record(box, tokens, lat)
        self._fail_all(RuntimeError("engine driver shut down"))

    def prewarm_rungs(self, submit_args_fn) -> None:
        """Drive every occupancy rung once: S concurrent dummy requests with
        staggered caps drain occupancy S → 1 (the solo path off)."""
        s = self.engine.S
        solo_was = self.solo_enabled
        self.solo_enabled = False
        try:
            with cf.ThreadPoolExecutor(s) as ex:
                futs = [ex.submit(self.submit_wait, *submit_args_fn(),
                                  max_new=min(self.engine.chunk * (i + 1),
                                              self.engine.default_max_new))
                        for i in range(s)]
                for f in futs:
                    f.result()
        finally:
            self.solo_enabled = solo_was

    def stats(self) -> dict:
        with self._cv:
            lats = sorted(self._latencies)
            inbox = len(self._inbox)
            waiting = len(self._waiters)

        def pct(p):
            return lats[min(len(lats) - 1, int(p / 100 * len(lats)))] if lats else 0.0

        return {
            "batcher": "continuous",
            "slots": self.engine.S,
            "chunk": self.engine.chunk,
            "graphs": self.engine.graphs,
            "admitted": self._admitted,
            "in_flight": waiting,
            "driver_inbox": inbox,
            "chunks": self._chunks,
            "mean_slot_occupancy": round(self._occ_sum / max(self._chunks, 1), 3),
            "solo_served": self._solo_served,
            "ar_p50_s": round(pct(50), 4),
            "ar_p95_s": round(pct(95), 4),
            "ar_p99_s": round(pct(99), 4),
        }


class VevoContinuousService(VevoService):
    """Vevo serving with the continuous engine on the AR stage.

    ``mode="voice"``: the AR decode runs in the engine's slots, and the
    flow matching and Vocos per finished request. ``mode="timbre"`` has no
    AR stage; it runs the FM tail directly. ``graphs`` is the engine's
    (None: CUDA graphs on the card, eager on the CPU)."""

    def __init__(self, pipeline, *, slots: int = 4, chunk: int = 64,
                 graphs: bool | None = None, **kw):
        self.slots_n, self.chunk, self._graphs = slots, chunk, graphs
        super().__init__(pipeline, **kw)

    def _init_dispatch(self, max_batch, max_wait_ms):
        del max_batch, max_wait_ms  # the window batcher's settings
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        if self.pipe.ar is None:
            self.driver = None  # a timbre-only deployment
            return
        engine = ContinuousARBatcher(
            self.pipe.ar, slots=self.slots_n, chunk=self.chunk,
            buckets=_ladder_tuple(self.len_step, self.max_content_len),
            out_buckets=_ladder_tuple(self.len_step, self.max_prompt_len),
            max_new=self.max_new, temperature=self.temperature, top_k=self.top_k,
            compute_dtype=self.pipe.compute_dtype, graphs=self._graphs)
        self.driver = EngineDriver(engine, solo_fn=self._solo_decode,
                                   solo_gate=lambda: self._inflight <= 1)

    def solo_tokens(self, content, seed: int, prompt_output=None) -> torch.Tensor:
        """One request's one-shot ragged decode at the engine's bucketed
        shapes, cache capacity and seed: the tokens the engine gives it."""
        eng = self.driver.engine
        dev = self.pipe.device
        content = torch.as_tensor(content, dtype=torch.long)
        buf = _pad_to(content, eng._bucket(len(content)))[None]
        po = polen = None
        if prompt_output is not None:
            prompt_output = torch.as_tensor(prompt_output, dtype=torch.long)
            po = _pad_to(prompt_output, eng._bucket(len(prompt_output), eng.out_buckets))[None]
            po, polen = po.to(dev), torch.tensor([len(prompt_output)], device=dev)
        toks, n = ar_transformer_generate_ragged(
            self.pipe.ar, buf.to(dev), torch.tensor([len(content)], device=dev),
            [torch.Generator(dev).manual_seed(int(seed))], max_new=self.max_new,
            temperature=self.temperature, top_k=self.top_k, prompt_output_tokens=po,
            prompt_output_len=polen, compute_dtype=self.pipe.compute_dtype,
            capacity=eng.capacity)
        return toks[0, :int(n[0])].cpu()

    def _solo_decode(self, content, seed, max_new=None, prompt_output=None):
        """The driver's solo path: `solo_tokens`, or None (decline) when the
        engine replays graphs or the request's cap is not the service's."""
        if self.driver.engine.graphs or (max_new or self.max_new) != self.max_new:
            return None
        return self.solo_tokens(content, seed, prompt_output)

    def synthesize(self, src_audio, ref_audio, mode: str = "timbre",
                   seed: int = 0) -> np.ndarray:
        with self._inflight_lock:
            self._inflight += 1
        try:
            return self._synthesize(src_audio, ref_audio, mode, seed)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def _synthesize(self, src_audio, ref_audio, mode, seed):
        req = self._prepare_request(src_audio, ref_audio, mode, seed)
        lp = self._ladder(len(req.fm_prompt_tokens), self.max_prompt_len)
        if mode == "timbre":
            lt = self._ladder(len(req.target_style), self.max_new)
            return self._run_batch(("timbre", (lt,), lp), [req])[0]
        if self.driver is None:
            raise RuntimeError("voice mode needs AR weights")
        # the window path's generators: the AR's tokens from 2 * seed + 1,
        # the FM noise from 2 * seed + 2
        toks = self.driver.submit_wait(req.content.cpu(), 2 * seed + 1, max_new=self.max_new,
                                       prompt_output=req.prompt_out.cpu())
        tl = max(len(toks), 1)
        target = _pad_to(toks.to(self.pipe.device), self._ladder(tl, self.max_new))[None]
        return self._fm_tail(lp, [req], target, [tl],
                             [voice_generators(seed, self.pipe.device)[1]])[0]

    def prewarm(self) -> None:
        """Walk the engine's bucket surface before serving traffic: one
        admission per (content, style) bucket pair and a chunk, S at a time
        (the solo path off), every rung (the graphs were captured when the
        engine was built), and the FM tail at the largest target bucket for
        the smallest and largest prompt buckets. A first request in a bucket
        pair otherwise pays the library's plans for its prefill shapes."""
        if self.driver is None:
            return
        eng = self.driver.engine
        steps = min(eng.chunk, eng.default_max_new)
        solo_was, self.driver.solo_enabled = self.driver.solo_enabled, False
        try:
            with cf.ThreadPoolExecutor(eng.S) as ex:
                futs = [ex.submit(self.driver.submit_wait, np.zeros(lb, np.int64), 0,
                                  max_new=steps,
                                  prompt_output=np.zeros(lo, np.int64) if lo else None)
                        for lb in eng.buckets for lo in eng.out_buckets or (0,)]
                for f in futs:
                    f.result()
        finally:
            self.driver.solo_enabled = solo_was
        self.driver.prewarm_rungs(lambda: (np.zeros(eng.buckets[0], np.int64), 0))
        dev = self.pipe.device
        csf = self.pipe.fm.cfg.cond_scale_factor
        lt = self._ladder(self.max_new, self.max_new)
        empty = torch.zeros((0,), dtype=torch.long, device=dev)
        for lp in sorted({self._ladder(1, self.max_prompt_len),
                          self._ladder(self.max_prompt_len, self.max_prompt_len)}):
            req = _VevoCoreRequest(
                "timbre", empty, empty, torch.zeros(lt, dtype=torch.long, device=dev),
                torch.zeros(lp, dtype=torch.long, device=dev),
                torch.zeros((lp * csf, self.pipe.fm.cfg.n_mel), device=dev), 0)
            self._run_batch(("timbre", (lt,), lp), [req])

    def stats(self) -> dict:
        return (self.driver.stats() if self.driver is not None
                else {"batcher": "continuous", "ar": None})

    def shutdown(self) -> None:
        if self.driver is not None:
            self.driver.shutdown()


class ValleContinuousService(VALLEService):
    """VALL-E serving with the continuous engine on the AR stage; the greedy
    NAR and the codec decode run per finished request (`nar_tail`), each
    request's tokens drawn from a generator seeded with its seed, as the
    window service draws them. ``graphs`` is the engine's (None: CUDA
    graphs on the card, eager on the CPU)."""

    def __init__(self, model, tokenizer, g2p, symbol_table, *, slots: int = 4,
                 chunk: int = 64, graphs: bool | None = None, **kw):
        self.slots_n, self.chunk, self._graphs = slots, chunk, graphs
        super().__init__(model, tokenizer, g2p, symbol_table, **kw)

    def _init_dispatch(self, max_batch, max_wait_ms):
        del max_batch, max_wait_ms  # the window batcher's settings
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        engine = ContinuousValleBatcher(
            self.model, slots=self.slots_n, chunk=self.chunk,
            phone_buckets=_ladder_tuple(self.len_step, self.max_phone_len),
            prompt_buckets=_ladder_tuple(self.len_step, self.max_prompt_len),
            max_new=self.max_new, temperature=self.temperature, top_k=self.top_k,
            compute_dtype=self.compute_dtype, graphs=self._graphs)
        self.driver = EngineDriver(engine, solo_fn=self._solo_decode,
                                   solo_gate=lambda: self._inflight <= 1)

    def solo_tokens(self, phones, prompt_tokens, seed: int) -> torch.Tensor:
        """One request's one-shot ragged AR decode at the engine's buckets,
        cache capacity and seed: the tokens the engine gives it."""
        eng = self.driver.engine
        dev = self.model.device
        phones = torch.as_tensor(phones, dtype=torch.long)
        prompt_tokens = torch.as_tensor(prompt_tokens, dtype=torch.long)
        toks, n = ar_generate_ragged(
            self.model, _pad_to(phones, eng._bucket(len(phones)))[None],
            torch.tensor([len(phones)]),
            _pad_to(prompt_tokens, eng._bucket(len(prompt_tokens), eng.out_buckets))[None],
            torch.tensor([len(prompt_tokens)]), [torch.Generator(dev).manual_seed(int(seed))],
            max_new=self.max_new, temperature=self.temperature, top_k=self.top_k,
            compute_dtype=self.compute_dtype, capacity=eng.capacity)
        return toks[0, :int(n[0])].cpu()

    def _solo_decode(self, phones, prompt_tokens, seed, max_new=None):
        """The driver's solo path: `solo_tokens`, or None (decline) when the
        engine replays graphs or the request's cap is not the service's."""
        if self.driver.engine.graphs or (max_new or self.max_new) != self.max_new:
            return None
        return self.solo_tokens(phones, prompt_tokens, seed)

    def synthesize(self, prompt_audio, prompt_text: str, target_text: str,
                   seed: int = 0) -> np.ndarray:
        with self._inflight_lock:
            self._inflight += 1
        try:
            req = self._prepare_request(prompt_audio, prompt_text, target_text, seed)
            toks0 = self.driver.submit_wait(req.phone_ids.cpu(), req.prompt_codes[0].cpu(),
                                            seed, max_new=self.max_new)
            return self.nar_tail(req, toks0)
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    def prewarm(self) -> None:
        """Walk the engine's bucket surface before serving traffic: one
        admission per (phone, prompt) bucket pair and a chunk, S at a time
        (the solo path off), every rung (captured when the engine was
        built), and the NAR and codec tail at the largest target bucket for
        the smallest and largest (phone, prompt) pairs."""
        eng = self.driver.engine
        steps = min(eng.chunk, eng.default_max_new)
        solo_was, self.driver.solo_enabled = self.driver.solo_enabled, False
        try:
            with cf.ThreadPoolExecutor(eng.S) as ex:
                futs = [ex.submit(self.driver.submit_wait, np.zeros(lph, np.int64),
                                  np.zeros(lp, np.int64), 0, max_new=steps)
                        for lph in eng.buckets for lp in eng.out_buckets]
                for f in futs:
                    f.result()
        finally:
            self.driver.solo_enabled = solo_was
        self.driver.prewarm_rungs(lambda: (np.zeros(eng.buckets[0], np.int64),
                                           np.zeros(eng.out_buckets[0], np.int64), 0))
        dev = self.model.device
        q = self.model.cfg.num_quantizers
        toks = torch.zeros(self.max_new, dtype=torch.long)
        for lph, lp in {(eng.buckets[0], eng.out_buckets[0]),
                        (eng.buckets[-1], eng.out_buckets[-1])}:
            req = _ValleCoreRequest(torch.zeros(lph, dtype=torch.long, device=dev),
                                    torch.zeros((q, lp), dtype=torch.long, device=dev), 0)
            self.nar_tail(req, toks)

    def stats(self) -> dict:
        return self.driver.stats()

    def shutdown(self) -> None:
        self.driver.shutdown()
