"""PyTorch port, the continuous engine (`serving/continuous.py`) and the
per-row-cursor decode step, on the CPU (where the engine steps eagerly).

- The port's engine against the JAX engine, greedy in float32: staggered
  admissions that cross rungs and compaction give equal tokens, and equal
  logits (within 1e-4) after an admission and after every chunk.
- The port's engine, sampled, against the port's one-shot ragged decode at
  the engine's capacity: token-exact per request, whatever the admission
  order, the per-request caps and the style prompts; over-long prompts
  raise at submission.
- The per-row-cursor step against the shared-cursor step when every row's
  cursor is the same: equal logits and caches.

The JAX side runs jitted; one JAX engine serves every greedy case.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.models.vc.ar_transformer import ARTransformer as JAR
from amphion_tpu.models.vc.ar_transformer import ARTransformerConfig as JARConfig
from amphion_tpu.serving.continuous import ContinuousARBatcher as JBatcher
from amphion_tpu_torch.models.vc.ar_transformer import (
    ARTransformer,
    ARTransformerConfig,
    ar_transformer_generate_ragged,
    prepare_for_decode,
)
from amphion_tpu_torch.serving.continuous import ContinuousARBatcher
from amphion_tpu_torch.utils.convert import from_flax

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)


CFG = dict(input_vocab=8, output_vocab=16, hidden=32, intermediate=64, num_layers=2,
           num_heads=2, max_position=512)
ENGINE = dict(slots=2, chunk=4, buckets=(16,), out_buckets=(8,), max_new=24, top_k=4,
              compute_dtype="float32")


@pytest.fixture(scope="module")
def models():
    jm = JAR(JARConfig(**CFG))
    toks = jnp.zeros((1, 6), jnp.int32)
    # every leaf random (Flax's shapes, traced by ``jax.eval_shape``, not compiled):
    # kernels normal over sqrt(fan_in), embeddings over sqrt(features), norm scales
    # (Flax's ones) uniform in [0.5, 1.5], the rest 0.1 normal
    shapes = jax.eval_shape(functools.partial(jm.init, method=JAR.loss), jax.random.key(0),
                            toks, jnp.ones((1, 6)), toks, jnp.ones((1, 6)))["params"]
    rng = np.random.default_rng(2)

    def leaf(path, s):
        name = path[-1].key
        adaptive = len(path) > 1 and path[-2].key == "to_weight"
        if name == "scale" or (adaptive and name == "bias"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        std = ((0.2 if adaptive else 1.0) / np.sqrt(np.prod(s.shape[:-1])) if name == "kernel"
               else 1.0 / np.sqrt(s.shape[-1]) if name == "embedding" else 0.1)
        return (std * rng.standard_normal(s.shape)).astype(np.float32)
    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    port = prepare_for_decode(from_flax(ARTransformer(ARTransformerConfig(**CFG)), params),
                              "float32")
    return jm, params, port


def _requests(seed: int, n: int):
    """(content, style prompt or None, cap) per request: uneven lengths,
    every other one style-prompted (so the slots' windows, and cursors,
    differ)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        content = rng.integers(0, CFG["input_vocab"], int(rng.integers(3, 15)))
        po = rng.integers(0, CFG["output_vocab"], int(rng.integers(1, 8))) if i % 2 else None
        out.append((content.astype(np.int32), po, [6, 24, 9, 24, 13, 17][i % 6]))
    return out


def _active_rows(eng) -> list[int]:
    return [i for i, s in enumerate(eng.slots) if s.req is not None]


def test_engine_matches_jax_engine_greedy(models):
    """Both engines in lockstep over a staggered schedule: the first
    request's admission alone, then a chunk at a time with requests
    arriving at chunk boundaries 1, 3, 4 and 5 (rungs 1 and 2; the first
    request retires at its cap while the second runs on, so compaction
    moves the second down a slot)."""
    jm, params, port = models
    jeng = JBatcher(jm, params, temperature=0.0, **ENGINE)
    eng = ContinuousARBatcher(port, temperature=0.0, **ENGINE)
    reqs = _requests(0, 5)
    jrids, rids = [], []

    def submit(content, po, cap):
        jrids.append(jeng.submit(content, jax.random.key(0), max_new=cap, prompt_output=po))
        rids.append(eng.submit(content, 0, max_new=cap, prompt_output=po))

    submit(*reqs[0])
    jeng._admit(0, jeng.queue.pop(0))
    eng._admit(0, eng.queue.pop(0))
    np.testing.assert_allclose(eng.logits[0].numpy(), np.asarray(jeng.logits)[0], atol=1e-4)
    arrivals = {1: reqs[1], 3: reqs[2], 4: reqs[3], 5: reqs[4]}
    rungs, moved = set(), False
    for step in range(40):
        if step in arrivals:
            submit(*arrivals[step])
        before = {s.req.rid: i for i, s in enumerate(eng.slots) if s.req}
        jeng.step_chunk()
        eng.step_chunk()
        rungs.add(eng.last_rung)
        moved |= any(before.get(s.req.rid, i) != i for i, s in enumerate(eng.slots) if s.req)
        act = _active_rows(eng)
        assert act == _active_rows(jeng)
        assert eng.cur[act].tolist() == np.asarray(jeng.cur)[act].tolist()
        np.testing.assert_allclose(eng.logits[act].numpy(), np.asarray(jeng.logits)[act],
                                   atol=1e-4)
        if not jeng.queue and not act and step > max(arrivals):
            break
    assert rungs == {1, 2} and moved
    assert len(eng.completed) == len(jeng.completed) == len(reqs)
    for jr, r in zip(jrids, rids):
        np.testing.assert_array_equal(eng.completed[r].numpy(), jeng.completed[jr])


def _solo(eng, port, content, seed, cap, po):
    buf = torch.zeros((1, eng._bucket(len(content))), dtype=torch.long)
    buf[0, :len(content)] = torch.from_numpy(content)
    kw = {}
    if po is not None:
        pb = torch.zeros((1, eng._bucket(len(po), eng.out_buckets)), dtype=torch.long)
        pb[0, :len(po)] = torch.from_numpy(po)
        kw = dict(prompt_output_tokens=pb, prompt_output_len=torch.tensor([len(po)]))
    toks, n = ar_transformer_generate_ragged(
        port, buf, torch.tensor([len(content)]), [torch.Generator().manual_seed(seed)],
        max_new=cap, top_k=4, compute_dtype="float32", capacity=eng.capacity, **kw)
    return toks[0, :int(n[0])]


@pytest.mark.parametrize("schedule", ["staggered", "all_at_once"])
def test_engine_sampled_matches_ragged_decode(models, schedule):
    """Sampled requests (temperature 1, top-k 4, their own seeds) give the
    tokens of their one-shot ragged decode at the engine's capacity: the
    draws follow the request, not its slot, rung or company; each stream
    stops at its own cap."""
    _, _, port = models
    eng = ContinuousARBatcher(port, slots=3, temperature=1.0, **{
        k: v for k, v in ENGINE.items() if k != "slots"})
    reqs = _requests(1, 6)
    rids = []
    for i, (content, po, cap) in enumerate(reqs):
        rids.append(eng.submit(content, 500 + i, max_new=cap, prompt_output=po))
        if schedule == "staggered" and i % 2:
            eng.step_chunk()
    done = eng.run()
    assert sorted(done) == sorted(rids)
    for rid, (content, po, cap), seed in zip(rids, reqs, range(500, 506)):
        want = _solo(eng, port, content, seed, cap, po)
        assert len(done[rid]) <= cap
        torch.testing.assert_close(done[rid], want, rtol=0, atol=0)
    stats = eng.stats()
    assert stats["completed"] == len(reqs) and stats["active"] == 0 and not stats["graphs"]


def test_engine_rejects_what_it_cannot_hold(models):
    _, _, port = models
    eng = ContinuousARBatcher(port, **ENGINE)
    with pytest.raises(ValueError, match="exceeds bucket"):
        eng.submit(np.zeros(17, np.int32), 0)
    with pytest.raises(ValueError, match="exceeds bucket"):
        eng.submit(np.zeros(3, np.int32), 0, prompt_output=np.zeros(9, np.int32))
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(np.zeros(3, np.int32), 0, max_new=10_000)
    plain = ContinuousARBatcher(port, **{**ENGINE, "out_buckets": ()})
    with pytest.raises(ValueError, match="out_buckets"):
        plain.submit(np.zeros(3, np.int32), 0, prompt_output=np.zeros(2, np.int32))
    assert not eng.queue and not plain.queue
    with pytest.raises(ValueError, match="CUDA"):
        ContinuousARBatcher(port, graphs=True, **ENGINE)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_per_row_cursor_step_matches_shared_cursor(models, dtype):
    """A step with a (B,) cursor tensor, every row at the same position,
    equals the step at that position as an int: logits and caches (the
    dense cache in float32, the int8 head-major cache in int8)."""
    _, params, _ = models
    torch.manual_seed(3)
    model = prepare_for_decode(from_flax(ARTransformer(ARTransformerConfig(**CFG)), params),
                               dtype)
    b, total = 3, 40
    with torch.inference_mode():
        caches = model.decoder.init_cache(b, total, model.embed_tokens.weight.dtype)
        x = torch.randint(0, 20, (b, 9))
        valid = torch.arange(total)[None, :] >= torch.tensor([[0], [2], [5]])
        model.decoder.forward_cached(model.embed_tokens(x), caches, 0, valid)
        twin = [tuple(t.clone() for t in c) for c in caches]
        tok = torch.tensor([1, 4, 7])
        shared, _ = model.step(tok, caches, 9, valid)
        per_row, _ = model.step(tok, twin, torch.full((b,), 9), valid)
    torch.testing.assert_close(per_row, shared, rtol=0, atol=0)
    for c, t in zip(caches, twin):
        for a, a2 in zip(c, t):
            assert torch.equal(a, a2)
