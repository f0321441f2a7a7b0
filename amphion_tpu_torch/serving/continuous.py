"""Continuous batching for the Vevo AR decode (port of
`amphion_tpu/serving/continuous.py`, `ContinuousARBatcher`).

The window batcher (`serving/service.py`) gates requests on a wait window:
a request that arrives while a batch decodes waits for the whole batch.
`ContinuousARBatcher` keeps S decode *slots* live and admits new requests
between chunks of decode steps:

- Every slot owns a row of the KV cache (leading dim S) and its own write
  cursor: the step takes the (S,) cursors as a tensor, so each row rotates,
  writes and masks at its own position (`LlamaDecoder.forward_cached`).
  Slots never attend each other.
- A request is admitted between chunks by a right-aligned prefill into its
  slot's row (`ARTransformer.prefill_ragged` on a 1-row view of the cache,
  written in place): the packed prompt lands at ``[0, l0)``, the cursor
  becomes ``l0``, and the row's ``kv_valid`` masks the pad prefix and the
  previous occupant's leftovers.
- A slot's capacity is ``max_bucket + 3 + max_out_bucket + max_new +
  chunk``: a cap-retired slot coasts to the chunk's end before its reuse.
- Decode runs ``chunk`` steps, then the host makes ONE fetch of the chunk's
  (tokens, done) and retires finished slots (EOS, or the request's cap:
  caps are host-side) and admits queued requests.
- The chunk runs the smallest rung of rows (1, 2, 4, …, S) covering the
  active slots, which are first compacted into a prefix (`_compact`, exact
  row copies): a row costs weight and cache traffic whether or not it
  holds a request.

The JAX engine runs a chunk as one compiled `lax.scan`. Here, on the card,
one decode step over a rung's rows is captured as a CUDA graph at
construction (every rung, before any slot is used), and a chunk is ``chunk``
replays of it: sampling, the EOS freeze, the step with cursors, the cursor
advance and the write of the step's token and done flag at a step index
held in a device tensor. Each slot draws from its own ``torch.Generator``,
registered with every rung's graph and reseeded at admission with the
request's seed, so a slot's draws follow its request as
`ar_transformer_generate_ragged`'s per-request generators do. Admission
and compaction run eagerly between chunks, as JAX runs them as programs of
their own. On the CPU the same step runs eagerly; on the card only
``graphs=False`` runs it eagerly (to hold the graphs against it), and a
failed capture or replay raises.

Token-exactness: a request's tokens equal its solo ragged decode at the
engine's cache capacity, whatever its company and admission time, as far
as the step's arithmetic does not depend on the number of rows: in float32
on the CPU, and on the card under int8/int4 at rungs of up to 8 rows (the
projections' GEMV path, the row-invariant `lm_head`, norms and attention
products); under float32/bf16 on the card cuBLAS products are not
row-invariant, nor are rungs past 8 rows (the projections' GEMM path).

`ContinuousValleBatcher` runs VALL-E's AR stage on the same engine: only
submission and admission differ (a ``[pad | phones_i | prompt_i]`` window,
no extra tokens).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from amphion_tpu_torch.models.vc.ar_transformer import check_decode_dtype
from amphion_tpu_torch.ops.kernels._build import LaunchTape
from amphion_tpu_torch.ops.sampling import sample_logits


@dataclasses.dataclass
class _Request:
    rid: int
    content: torch.Tensor  # (L,) raw content ids, on the host
    seed: int  # the request's own generator seed: sampling does not follow scheduling
    max_new: int
    prompt_output: torch.Tensor | None = None  # style prompt (Vevo-Voice)
    submit_t: float = 0.0
    admit_t: float = 0.0


@dataclasses.dataclass
class _Slot:
    req: _Request | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)


def _ids(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64) if not torch.is_tensor(x) else x,
                           dtype=torch.long).cpu()


class ContinuousARBatcher:
    """Slot-based continuous batching over a prepared AR model: the Vevo
    `ARTransformer` here, VALL-E in `ContinuousValleBatcher`. The engine
    calls the model's decode interface only: ``decoder.init_cache``,
    ``step``, ``cfg.eos_id``, ``decode_vocab``, ``device``, and, at
    admission, its prefill (`_prefill`).

    Synchronous driver: `submit()` enqueues, `step_chunk()` admits, decodes
    one chunk and returns the requests finished in it, `run()` loops until
    drained. One thread drives it (`serving/continuous_service.EngineDriver`).
    """

    WINDOW_EXTRA = 3  # the packed window's tokens beyond its buckets (IN_BOS, IN_EOS, OUT_BOS)

    def __init__(self, model, *, slots: int = 4, capacity: int | None = None,
                 chunk: int = 16, buckets: tuple[int, ...] = (64, 128, 256),
                 out_buckets: tuple[int, ...] = (), max_new: int = 256,
                 temperature: float = 1.0, top_k: int = 40, top_p: float = 1.0,
                 compute_dtype: str = "bfloat16", graphs: bool | None = None):
        dt = check_decode_dtype(model, compute_dtype)  # the model is prepared for it
        self.model, self.dev = model, model.device
        self.S, self.chunk = slots, chunk
        self.buckets = tuple(sorted(buckets))
        self.out_buckets = tuple(sorted(out_buckets))
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.eos = model.cfg.eos_id
        self.base = (self.buckets[-1] + self.WINDOW_EXTRA
                     + (self.out_buckets[-1] if self.out_buckets else 0))
        self.capacity = max(capacity or 0, self.base + max_new + chunk)
        if self.capacity > model.cfg.max_position:
            raise ValueError(f"per-slot capacity {self.capacity} exceeds the model's "
                             f"max_position {model.cfg.max_position}")
        self.default_max_new = max_new
        self.graphs = self.dev.type == "cuda" if graphs is None else graphs
        if self.graphs and self.dev.type != "cuda":
            raise ValueError("CUDA graphs need the model on a CUDA device")

        with torch.inference_mode():
            self.caches = model.decoder.init_cache(slots, self.capacity, dt, self.dev)
            # idle rows keep cache slot 0 attendable, so no softmax row is
            # fully masked (the `LlamaDecoder.forward_cached` rule for pads)
            self.kv_valid = torch.zeros((slots, self.capacity), dtype=torch.bool,
                                        device=self.dev)
            self.kv_valid[:, 0] = True
            self.logits = torch.zeros((slots, model.decode_vocab), device=self.dev)
            self.done = torch.ones((slots,), dtype=torch.bool, device=self.dev)  # freeze flags
            self.cur = torch.ones((slots,), dtype=torch.long, device=self.dev)  # write cursors
            # the chunk's outputs, written at the step index `step_idx`
            self.out_tok = torch.zeros((slots, chunk), dtype=torch.long, device=self.dev)
            self.out_done = torch.zeros((slots, chunk), dtype=torch.bool, device=self.dev)
            self.step_idx = torch.zeros((1,), dtype=torch.long, device=self.dev)
        self.gens = [torch.Generator(self.dev).manual_seed(0) for _ in range(slots)]
        self.slots = [_Slot() for _ in range(slots)]
        self.queue: list[_Request] = []
        self._next_rid = 0
        self.completed: dict[int, torch.Tensor] = {}
        self.latency_s: dict[int, float] = {}
        self.last_rung = 0  # rows run by the most recent chunk
        self.chunks = 0
        self.rungs = sorted({min(1 << i, slots) for i in range(slots.bit_length() + 1)})
        self._graph: dict[int, tuple[torch.cuda.CUDAGraph, LaunchTape]] = {}
        self.capture_s: dict[int, float] = {}
        if self.graphs:
            self._capture_all()

    # ------------------------------------------------------------ the step
    def _step(self, r: int) -> None:
        """One decode step over the first ``r`` rows, in place on the
        engine's buffers (the body of JAX's chunk `lax.scan`): sample, freeze
        rows that drew EOS, step each row at its cursor, advance the
        cursors of rows still running, write the token and done flag at
        ``step_idx``."""
        tok = sample_logits(self.logits[:r], self.gens[:r], self.temperature, self.top_k,
                            self.top_p)
        done = self.done[:r] | (tok == self.eos)
        tok = torch.where(done, 0, tok)
        caches = [tuple(t[:r] for t in c) for c in self.caches]
        logits, _ = self.model.step(tok, caches, self.cur[:r], self.kv_valid[:r])
        self.logits[:r].copy_(logits)
        self.cur[:r].add_((~done).long())
        self.done[:r].copy_(done)
        self.out_tok[:r].index_copy_(1, self.step_idx, tok[:, None])
        self.out_done[:r].index_copy_(1, self.step_idx, done[:, None])
        self.step_idx.add_(1)

    @torch.inference_mode()
    def _capture_all(self) -> None:
        """Capture one step per rung, all in one memory pool. Runs while
        every slot is idle: the warm-up step before each capture writes only
        idle rows (frozen cursors, logits and cache rows an admission
        replaces). The graphs' temporaries share the pool; all state they
        carry lives in the engine's buffers, so they replay in any order."""
        pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(self.dev)
        for r in self.rungs:
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            for g in self.gens[:r]:
                graph.register_generator_state(g)
            side.wait_stream(torch.cuda.current_stream(self.dev))
            with torch.cuda.stream(side):
                self._step(r)  # warm-up, as a capture needs
            torch.cuda.current_stream(self.dev).wait_stream(side)
            with LaunchTape() as tape, torch.cuda.graph(graph, pool=pool, stream=side):
                self._step(r)
            torch.cuda.synchronize(self.dev)
            self._graph[r] = (graph, tape)
            self.capture_s[r] = time.perf_counter() - t0
        self.step_idx.zero_()

    def step_launches(self, r: int) -> dict[str, int]:
        """The port's kernel launches in one captured step of rung ``r``."""
        return self._graph[r][1].launches()

    def _decode_chunk(self, r: int) -> torch.Tensor:
        """``chunk`` steps over the first ``r`` rows → the chunk's one host
        fetch: (r, 2 * chunk) of [tokens | done after each step]."""
        self.step_idx.zero_()
        if self.graphs:
            graph, tape = self._graph[r]
            for _ in range(self.chunk):
                graph.replay()
            tape.replayed(self.chunk)
        else:
            for _ in range(self.chunk):
                self._step(r)
        return torch.cat([self.out_tok[:r], self.out_done[:r].long()], dim=1).cpu()

    # ------------------------------------------------------------- API
    def submit(self, content, seed: int, max_new: int | None = None,
               prompt_output=None) -> int:
        """Enqueue a request; ``seed`` seeds the generator its tokens are
        drawn from. ``prompt_output`` is the optional output-stream style
        prompt (Vevo-Voice). Raises now, not at admission, for a prompt
        longer than the buckets or a window that overflows the capacity."""
        content = _ids(content)
        window = self._bucket(len(content)) + self.WINDOW_EXTRA
        po = None if prompt_output is None else _ids(prompt_output)
        if po is not None:
            if not self.out_buckets:
                raise ValueError(
                    "style-prompted request on an engine built without out_buckets; "
                    "pass out_buckets=(...) at init (the content ladder is not reused "
                    "for the style stream: the capacity was sized without it)")
            window += self._bucket(len(po), self.out_buckets)
        max_new = max_new or self.default_max_new
        if max_new + window + self.chunk > self.capacity:
            raise ValueError("max_new + packed window exceeds the engine's per-slot "
                             "capacity; raise capacity/max_new at init")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(_Request(rid, content, int(seed), max_new, prompt_output=po,
                                   submit_t=time.perf_counter()))
        return rid

    def _bucket(self, n: int, ladder=None) -> int:
        # `ladder if ... is not None`, not `ladder or`: an empty out_buckets
        # must not fall back to the content ladder (the capacity was sized
        # without a style stream)
        ladder = self.buckets if ladder is None else ladder
        if not ladder:
            raise ValueError("empty bucket ladder")
        for b in ladder:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds bucket {ladder[-1]}")

    @torch.inference_mode()
    def _admit(self, slot: int, req: _Request) -> None:
        """Prefill the request right-aligned into row ``slot``; its cursor
        becomes the window's end ``l0`` and its generator is reseeded."""
        l0, row_valid, logits = self._prefill(slot, req)
        self.kv_valid[slot] = row_valid[0]
        self.logits[slot] = logits[0]
        self.done[slot] = False
        self.cur[slot] = l0
        self.gens[slot].manual_seed(req.seed)
        req.admit_t = time.perf_counter()
        self.slots[slot] = _Slot(req=req)

    def _prefill(self, slot: int, req: _Request):
        """The request's packed window prefilled into row ``slot`` (a 1-row
        view of the cache, written in place) → (window end ``l0``, the row's
        (1, capacity) validity, its (1, V) logits)."""
        dev = self.dev
        n = len(req.content)
        lb = self._bucket(n)
        buf = torch.zeros((1, lb), dtype=torch.long)
        buf[0, :n] = req.content
        l0, packed = lb + 3, n + 3
        po = polen = None
        if req.prompt_output is not None:
            m = len(req.prompt_output)
            lo = self._bucket(m, self.out_buckets)
            po = torch.zeros((1, lo), dtype=torch.long)
            po[0, :m] = req.prompt_output
            po, polen = po.to(dev), torch.tensor([m], device=dev)
            l0, packed = l0 + lo, packed + m
        row_valid = torch.arange(self.capacity, device=dev)[None, :] >= l0 - packed
        rows = [tuple(t[slot:slot + 1] for t in c) for c in self.caches]
        logits, _, _ = self.model.prefill_ragged(
            buf.to(dev), torch.tensor([n], device=dev), rows, row_valid,
            prompt_output_tokens=po, prompt_output_len=polen, cache_index=0)
        return l0, row_valid, logits

    def _retire(self, idx: int, n_keep: int) -> None:
        s = self.slots[idx]
        self.completed[s.req.rid] = torch.tensor(s.tokens[:n_keep], dtype=torch.long)
        self.latency_s[s.req.rid] = time.perf_counter() - s.req.submit_t
        self.slots[idx] = _Slot()

    # ------------------------------------------ occupancy-adaptive run
    def _rung(self, n_active: int) -> int:
        """Smallest rung (a power of two, at most S) covering n_active rows."""
        r = 1
        while r < n_active:
            r *= 2
        return min(r, self.S)

    @torch.inference_mode()
    def _move_slot(self, src: int, dst: int) -> None:
        """Copy row ``src`` (cache, validity, logits, flags, cursor and its
        generator's state) to ``dst`` and freeze ``src``."""
        for c in self.caches:
            for t in c:
                t[dst] = t[src]
        for t in (self.kv_valid, self.logits, self.done, self.cur):
            t[dst] = t[src]
        self.done[src] = True
        self.gens[dst].set_state(self.gens[src].get_state())

    def _compact(self) -> None:
        """Move the highest active slot into the lowest free one until the
        active slots form a prefix; a moved request's stream goes on
        bit-identically."""
        while True:
            act = [i for i, s in enumerate(self.slots) if s.req is not None]
            if not act:
                return
            holes = [i for i in range(act[-1]) if self.slots[i].req is None]
            if not holes:
                return
            src, dst = act[-1], holes[0]
            self._move_slot(src, dst)
            self.slots[dst], self.slots[src] = self.slots[src], _Slot()

    @torch.inference_mode()
    def step_chunk(self) -> list[int]:
        """Admit queued requests, decode one chunk, retire finished slots;
        returns the rids completed by this call."""
        for i in range(self.S):
            if self.slots[i].req is None and self.queue:
                self._admit(i, self.queue.pop(0))
        n_active = sum(s.req is not None for s in self.slots)
        if n_active == 0:
            return []
        self._compact()
        r = self.last_rung = self._rung(n_active)
        packed = self._decode_chunk(r).numpy()  # the chunk's one host fetch
        self.chunks += 1
        toks, dones = packed[:, :self.chunk], packed[:, self.chunk:].astype(bool)
        finished, cap_frozen = [], []
        for i, s in enumerate(self.slots[:r]):
            if s.req is None:
                continue
            # steps after the slot froze emit 0s; the EOS step itself is not
            # a real token (the ragged decode's gen_len)
            n_real = len(s.tokens) + int(np.sum(~dones[i]))
            s.tokens.extend(int(t) for t in toks[i])
            if dones[i, -1] or len(s.tokens) >= s.req.max_new:
                finished.append(s.req.rid)
                if not dones[i, -1]:
                    cap_frozen.append(i)  # stop its stepping too
                self._retire(i, min(s.req.max_new, n_real))
        if cap_frozen:
            self.done[torch.tensor(cap_frozen)] = True
        return finished

    def run(self, max_chunks: int = 10_000) -> dict[int, torch.Tensor]:
        """Drive until queue and slots drain; returns {rid: tokens}."""
        for _ in range(max_chunks):
            if not self.queue and all(s.req is None for s in self.slots):
                break
            self.step_chunk()
        return dict(self.completed)

    # --------------------------------------------------------- metrics
    def stats(self) -> dict:
        lats = sorted(self.latency_s.values())

        def pct(p):
            return lats[min(len(lats) - 1, int(p / 100 * len(lats)))] if lats else 0.0

        return {"completed": len(self.completed), "queued": len(self.queue),
                "active": sum(s.req is not None for s in self.slots),
                "last_rung": self.last_rung, "chunks": self.chunks,
                "cursors": self.cur.tolist(), "graphs": self.graphs,
                "p50_s": pct(50), "p95_s": pct(95), "p99_s": pct(99)}


class ContinuousValleBatcher(ContinuousARBatcher):
    """Continuous batching over VALL-E's AR (codebook-0) stage, a model
    prepared by `models/tts/valle/valle.prepare_for_decode`.

    The base engine's step, rung graphs, per-slot generators and compaction
    run unchanged; a request is (phones, prompt codebook-0 tokens), and its
    window the right-aligned ``[pad | phones_i | prompt_i]`` of
    `VALLE.ar_prefill_ragged`, phones on ``phone_buckets`` and the prompt
    on ``prompt_buckets``. A slot's capacity is ``phone_buckets[-1] +
    prompt_buckets[-1] + max_new + chunk``; a request's tokens equal its
    `ar_generate_ragged` at that cache capacity, under the base engine's
    conditions. The NAR and the codec decode run outside the engine, per
    finished request (`serving/continuous_service.ValleContinuousService`)."""

    WINDOW_EXTRA = 0

    def __init__(self, model, *, slots: int = 4, capacity: int | None = None,
                 chunk: int = 16, phone_buckets: tuple[int, ...] = (64, 128, 256),
                 prompt_buckets: tuple[int, ...] = (128, 256), max_new: int = 768,
                 temperature: float = 1.0, top_k: int = 50, top_p: float = 1.0,
                 compute_dtype: str = "bfloat16", graphs: bool | None = None):
        super().__init__(model, slots=slots, capacity=capacity, chunk=chunk,
                         buckets=phone_buckets, out_buckets=prompt_buckets, max_new=max_new,
                         temperature=temperature, top_k=top_k, top_p=top_p,
                         compute_dtype=compute_dtype, graphs=graphs)

    def submit(self, phones, prompt_tokens, seed: int, max_new: int | None = None) -> int:
        """Enqueue (phones, codebook-0 prompt tokens); ``seed`` seeds the
        generator its tokens are drawn from."""
        return super().submit(phones, seed, max_new=max_new, prompt_output=prompt_tokens)

    def _prefill(self, slot: int, req: _Request):
        dev = self.dev
        n, m = len(req.content), len(req.prompt_output)
        lb, lo = self._bucket(n), self._bucket(m, self.out_buckets)
        phones = torch.zeros((1, lb), dtype=torch.long)
        phones[0, :n] = req.content
        prompt = torch.zeros((1, lo), dtype=torch.long)
        prompt[0, :m] = req.prompt_output
        l0 = lb + lo
        row_valid = torch.arange(self.capacity, device=dev)[None, :] >= l0 - (n + m)
        rows = [tuple(t[slot:slot + 1] for t in c) for c in self.caches]
        logits, _ = self.model.ar_prefill_ragged(
            phones.to(dev), torch.tensor([n], device=dev), prompt.to(dev),
            torch.tensor([m], device=dev), rows, row_valid)
        return l0, row_valid, logits
