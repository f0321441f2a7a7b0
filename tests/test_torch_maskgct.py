"""PyTorch port, MaskGCT models, ragged samplers and `MaskGCTService` on the
CPU, against the JAX package: the text front end, both DiffLlama
backbones, one T2S and one S2A step's logits at mixed lengths (the S2A
with token and with float conditioning), both ragged samplers and the
whole service batch token for token with JAX's own Gumbel draws injected.

Two settings, one tiny JAX model per stage in each: the configs of
`tests/test_ragged_sampling.py` for the backbones and steps (an S2A tree
holding both ``cond_emb`` and ``sem_proj``, so one model serves both
conditionings), and those of `tests/test_serving.py` for the samplers and
the service (an S2A trained on the mel-proxy path: ``sem_proj`` only). The
sampler tests call the JAX samplers with the service's static arguments
and shapes, so the service's batch reuses their compiled programs. Trees
come from ``jax.eval_shape`` filled from a numpy seed and reach the port
through `utils/convert.from_flax`; every JAX side runs jitted. JAX's draws
come from the JAX module's own key splitting (`ragged_sampling._split_each`)
and noise (`_vmapped_gumbel`), in the order its samplers draw them.
Tolerances: float32 logits and hidden states 1e-4 absolute, waveforms 1e-4;
ids and tokens exact.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.models.tts.maskgct import ragged_sampling as jrs
from amphion_tpu.models.tts.maskgct.maskgct import MaskGCTS2A as JS2A
from amphion_tpu.models.tts.maskgct.maskgct import MaskGCTT2S as JT2S
from amphion_tpu.models.tts.maskgct.maskgct import S2AConfig as JS2AConfig
from amphion_tpu.models.tts.maskgct.maskgct import T2SConfig as JT2SConfig
from amphion_tpu.models.tts.maskgct.maskgct import _topk_filter_frac as j_topk
from amphion_tpu.text import cleaners as jcleaners
from amphion_tpu.text.g2p import G2PModule as JG2P
from amphion_tpu.text.g2p import intersperse as j_intersperse
from amphion_tpu_torch.models.tts.maskgct import ragged_sampling as prs
from amphion_tpu_torch.models.tts.maskgct.maskgct import (
    MaskGCTS2A,
    MaskGCTT2S,
    S2AConfig,
    T2SConfig,
    _topk_filter_frac,
    mask_prob_schedule,
    s2a_conditioning,
)
from amphion_tpu_torch.text import cleaners
from amphion_tpu_torch.text.g2p import G2PModule, intersperse
from amphion_tpu_torch.text.symbol_table import SymbolTable
from amphion_tpu_torch.utils.convert import from_flax

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)

# the backbones at the tiny T2S config of `tests/test_ragged_sampling.py` (2 layers)
T2S_TINY = dict(hidden=32, num_layers=2, num_heads=4, codebook_size=24, phone_vocab=16,
                max_position=128)


def fill(shapes, seed: int):
    """Random leaves for a Flax tree of ``jax.ShapeDtypeStruct``s: kernels
    normal over √fan_in, embeddings and codebooks normal, biases small (the
    adaptive norms' ``to_weight`` bias near 1), scales and Snake α in
    [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        scopes = [getattr(k, "key", "") for k in path]
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(
                np.float32)
        if name == "bias":
            base = 1.0 if "to_weight" in scopes else 0.0
            return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("scale", "alpha") or name.endswith("/scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _step_draws(keys, t_max, vocab):
    """One mask-predict step's draws, as the JAX samplers split and draw. The
    (t_max, vocab) noise is drawn flat and reshaped: the same bits (threefry
    counts over the flattened shape), and at vocab 16 under half the
    compile time of the 2-D draw."""
    keys, a, b = jrs._split_each(keys, 3)
    noise = jrs._vmapped_gumbel(a, (t_max * vocab,)).reshape(-1, t_max, vocab)
    return keys, noise, jrs._vmapped_gumbel(b, (t_max,))


_split2 = jax.jit(lambda keys: jrs._split_each(keys, 2))


def t2s_draws(keys, n_steps: int, t_max: int, vocab: int) -> list:
    """JAX's Gumbel draws of a ragged T2S run from (B,) keys, in draw order."""
    out = []
    for _ in range(n_steps):
        keys, a, b = _step_draws(keys, t_max, vocab)
        out += [np.asarray(a), np.asarray(b)]
    return out


def s2a_draws(keys, n_q: int, first: int, rest: int, t_max: int, vocab: int) -> list:
    """JAX's Gumbel draws of a ragged S2A run from (B,) keys, in draw order:
    each layer's steps from a key split off before it."""
    out = []
    for q in range(n_q):
        keys, layer_keys = _split2(keys)
        out += t2s_draws(layer_keys, first if q == 0 else rest, t_max, vocab)
    return out


def L(a):
    return torch.from_numpy(np.array(a)).long()


def F32(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def backbones():
    """JAX's DiffLlamaPrefixEncoder and DiffLlamaEncoder at the tiny T2S
    config, their trees and the port's modules."""
    from amphion_tpu.modules.llama import DiffLlamaEncoder as JDiff
    from amphion_tpu.modules.llama import DiffLlamaPrefixEncoder as JPrefix
    from amphion_tpu_torch.modules.llama import DiffLlamaEncoder, DiffLlamaPrefixEncoder

    x, t, m = jnp.zeros((1, 4, 32)), jnp.zeros((1,)), jnp.ones((1, 4))
    jp, jd = JPrefix(JT2SConfig(**T2S_TINY).llama()), JDiff(JT2SConfig(**T2S_TINY).llama())
    tp = fill(jax.eval_shape(jp.init, jax.random.key(0), x, t, m, x, m)["params"], 1)
    td = fill(jax.eval_shape(jd.init, jax.random.key(0), x, t, x, m)["params"], 2)
    cfg = T2SConfig(**T2S_TINY).llama()
    return ((jp, tp, from_flax(DiffLlamaPrefixEncoder(cfg), tp).eval()),
            (jd, td, from_flax(DiffLlamaEncoder(cfg), td).eval()))


# -- text front end ------------------------------------------------------------------


def test_text_front_end_ids_match_jax(tmp_path):
    texts = ["Hello, Dr. Smith: it's 3:45 -- $12.50 on 1984's gain!",
             "Ünïcödé café, naïve; (MRS. Jones) 1,200 feet.", "  spaced   out\ttext  "]
    for t in texts:
        assert cleaners.english_cleaners(t) == jcleaners.english_cleaners(t)
        assert cleaners.basic_cleaners(t) == jcleaners.basic_cleaners(t)
    lex = tmp_path / "lexicon.txt"
    lex.write_text(";;; comment\nHELLO  HH AH0 L OW1\nHELLO(2)  HH EH0 L OW1\nSMITH  S M IH1 TH\n"
                   "D  D IY1\nR  AA1 R\nIT'S  IH1 T S\n")
    for backend in ("char", "lexicon"):
        kw = {"lexicon_path": str(lex)} if backend == "lexicon" else {}
        port, ref = G2PModule(backend, **kw), JG2P(backend, **kw)
        table, jtable = port.build_symbol_table(texts), ref.build_symbol_table(texts)
        assert table.symbols == jtable.symbols
        for t in texts + ["unseen words zq"]:
            assert port.phonemes(t) == ref.phonemes(t)
            assert port.to_ids(t, table) == ref.to_ids(t, jtable)
        path = tmp_path / f"{backend}.dict"
        table.to_file(path)
        back = SymbolTable.from_file(path)
        assert back.symbols == table.symbols and back[" "] == table[" "]
    assert intersperse([3, 4]) == j_intersperse([3, 4]) == [0, 3, 0, 4, 0]
    with pytest.raises(NotImplementedError, match="multilingual"):
        G2PModule("multilingual")


def test_topk_filter_and_schedule_match_jax():
    logits = np.random.default_rng(3).standard_normal((2, 5, 300)).astype(np.float32)
    thresholds = (0.98, 0.5, 0.999)
    wants = jax.jit(lambda x: [j_topk(x, thres) for thres in thresholds])(logits)
    for thres, want in zip(thresholds, wants):
        np.testing.assert_array_equal(_topk_filter_frac(F32(logits), thres).numpy(),
                                      np.asarray(want))
    t = np.linspace(0, 1, 9, dtype=np.float32)
    np.testing.assert_allclose(mask_prob_schedule(F32(t)).numpy(), np.sin(t * np.pi / 2),
                               atol=1e-6)


# -- backbones ---------------------------------------------------------------


def test_diffllama_backbones_match_jax(backbones):
    """DiffLlamaPrefixEncoder (the T2S backbone) with a padded phone prefix
    and DiffLlamaEncoder (the S2A backbone) with a key mask."""
    b, tm, lph = 3, 10, 7
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, tm, 32)).astype(np.float32)
    t = np.array([0.9, 0.5, 0.1], np.float32)
    x_mask = (np.arange(tm)[None] < np.array([10, 7, 9])[:, None]).astype(np.float32)
    phone = rng.standard_normal((b, lph, 32)).astype(np.float32)
    p_mask = (np.arange(lph)[None] < np.array([7, 4, 6])[:, None]).astype(np.float32)
    cond = rng.standard_normal((b, tm, 32)).astype(np.float32)
    (jp, tp, pp), (jd, td, pd) = backbones
    want_p, want_d = jax.jit(lambda: (jp.apply({"params": tp}, x, t, x_mask, phone, p_mask),
                                      jd.apply({"params": td}, x, t, cond, x_mask)))()
    with torch.no_grad():
        got_p = pp(F32(x), F32(t), F32(x_mask), F32(phone), F32(p_mask))
        got_d = pd(F32(x), F32(t), F32(cond), F32(x_mask))
    valid = x_mask.astype(bool)
    for got, want in ((got_p, want_p), (got_d, want_d)):
        assert got.shape == want.shape == (b, tm, 32)
        np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=1e-4)


# -- samplers and the service (the serving tiny configs) ----------------------------------

SV_T2S = dict(hidden=32, num_layers=1, num_heads=4, codebook_size=24, phone_vocab=64,
              max_position=256)
SV_S2A = dict(hidden=32, num_layers=1, num_heads=4, codebook_size=16, num_quantizers=2,
              semantic_dim=24, max_position=256)
SV_SEM = dict(feature_dim=8, hidden=24, codebook_size=24, codebook_dim=4, num_blocks=1)
SV_CODEC = dict(sample_rate=8000, encoder_dim=4, latent_dim=8, decoder_dim=4, strides=(2, 4),
                num_quantizers=2, codebook_size=16, codebook_dim=4)
SV_BUCKET = (8, 16, 16)  # (prompt, phone, target) rungs of every request below
SV_SERVICE = dict(max_batch=3, max_wait_ms=60000.0, len_step=8, max_prompt_len=8,
                  max_target_len=16, max_phone_len=16, audio_grid_s=0.005)
SV_T2S_KW = {"n_steps": 4, "compute_dtype": "float32"}
SV_S2A_KW = {"first_layer_steps": 3, "compute_dtype": "float32"}
# (prompt samples, prompt text, target text, target_len, seed): one bucket, mixed phone
# and target lengths (the prompts share one 80-sample grid: one front-end shape)
SV_REQUESTS = [(72, "hi there", "go", 11, 21), (80, "a b", "hello you", 16, 22),
               (64, "prompt", "words here", 13, 23)]


def _sv_keys(seeds, stage: int):
    keys = jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.uint32))
    return jax.vmap(lambda k: jax.random.fold_in(k, stage))(keys)


@pytest.fixture(scope="module")
def sv():
    """The serving-tiny models: JAX trees and modules, and the port's."""
    from amphion_tpu.models.codec.amphion_codec import AmphionCodec as JCodec
    from amphion_tpu.models.codec.amphion_codec import CodecConfig as JCodecConfig
    from amphion_tpu.models.codec.repcodec import RepCodec as JRepCodec
    from amphion_tpu.models.codec.repcodec import RepCodecConfig as JRepCodecConfig

    jt, js = JT2S(JT2SConfig(**SV_T2S)), JS2A(JS2AConfig(**SV_S2A))
    jsem, jac = JRepCodec(JRepCodecConfig(**SV_SEM)), JCodec(JCodecConfig(**SV_CODEC))
    shape = jax.eval_shape
    trees = {
        "t2s": shape(functools.partial(jt.init, method=JT2S.compute_loss), jax.random.key(0),
                     jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8)),
                     jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4)), jax.random.key(1)),
        "s2a": shape(functools.partial(js.init, method=JS2A.compute_loss), jax.random.key(0),
                     jnp.zeros((1, 2, 8), jnp.int32), jnp.ones((1, 8)), jnp.zeros((1, 8, 24)),
                     jax.random.key(1)),
        "semantic_codec": shape(jsem.init, jax.random.key(0), jnp.zeros((1, 8, 8))),
        "acoustic_codec": shape(jac.init, jax.random.key(0), jnp.zeros((1, 32))),
    }
    trees = {k: fill(v["params"], 10 + i) for i, (k, v) in enumerate(trees.items())}
    assert s2a_conditioning(trees["s2a"]) == (False, True)  # the mel-proxy S2A
    # the same S2A with token conditioning too (its cond_emb as Flax shapes it)
    emb = np.random.default_rng(14).standard_normal((JS2AConfig(**SV_S2A).cond_codebook_size,
                                                     SV_S2A["hidden"])).astype(np.float32)
    trees["s2a_both"] = {**trees["s2a"], "cond_emb": {"embedding": emb}}
    return {"jax": {"t2s": jt, "s2a": js, "semantic_codec": jsem, "acoustic_codec": jac},
            "trees": trees,
            "t2s": from_flax(MaskGCTT2S(T2SConfig(**SV_T2S)), trees["t2s"]).eval(),
            "s2a": from_flax(MaskGCTS2A(S2AConfig(**SV_S2A), False, True),
                             trees["s2a"]).eval(),
            "s2a_both": from_flax(MaskGCTS2A(S2AConfig(**SV_S2A)), trees["s2a_both"]).eval()}


def _sv_inputs(seed):
    lp, lph, tm = SV_BUCKET
    rng = np.random.default_rng(seed)
    i32 = functools.partial(np.asarray, dtype=np.int32)
    return dict(prompt=i32(rng.integers(0, 24, (3, lp))), plen=i32([5, 8, 7]),
                phone=i32(rng.integers(1, 64, (3, lph))), phlen=i32([10, 12, 16]),
                tlen=i32([11, 16, 13]), prompt_ac=i32(rng.integers(0, 16, (3, 2, lp))),
                sem=rng.standard_normal((3, lp + tm, 24)).astype(np.float32),
                seq=i32(rng.integers(0, 24, (3, tm))), mask=rng.random((3, tm)) < 0.6,
                acoustic=i32(rng.integers(0, 16, (3, 2, tm))))


def test_t2s_step_logits_match_jax(sv):
    jm, tree, pm = sv["jax"]["t2s"], sv["trees"]["t2s"], sv["t2s"]
    d = _sv_inputs(5)
    tm = SV_BUCKET[2]
    t = np.array([0.8, 0.8, 0.8], np.float32)
    want = jax.jit(lambda *a: jm.apply({"params": tree}, *a, 1.5, 0.75,
                                       method=jrs._t2s_step_ragged))(
        d["seq"], d["mask"], d["tlen"], t, d["prompt"], d["plen"], d["phone"], d["phlen"])
    with torch.no_grad():
        got = prs._t2s_step_ragged(pm, L(d["seq"]), torch.from_numpy(d["mask"]), L(d["tlen"]),
                                   F32(t), L(d["prompt"]), L(d["plen"]), L(d["phone"]),
                                   L(d["phlen"]), 1.5, 0.75)
    valid = np.arange(tm)[None] < d["tlen"][:, None]
    assert got.shape == (3, tm, 24)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=1e-4)


def test_s2a_step_logits_match_jax(sv):
    """An S2A whose tree holds both ``cond_emb`` and ``sem_proj``, stepped
    with token and with float conditioning; each row on its own RVQ layer
    (below, at and above the target layer all occur)."""
    jm, tree, pm = sv["jax"]["s2a"], sv["trees"]["s2a_both"], sv["s2a_both"]
    d = _sv_inputs(6)
    tm = SV_BUCKET[2]
    tokens = np.asarray(jrs.pack_prefix_target(jnp.asarray(d["prompt"]), jnp.asarray(d["seq"]),
                                               jnp.asarray(d["plen"])))
    layer = np.array([0, 1, 0])
    t = np.array([0.7, 0.7, 0.7], np.float32)

    @jax.jit
    def both(tokens, feats):
        def step(sem):
            return jm.apply({"params": tree}, d["acoustic"], d["mask"], d["tlen"], layer, t,
                            sem, d["prompt_ac"], d["plen"], 1.5, 0.75,
                            method=jrs._s2a_step_ragged)
        return step(tokens), step(feats)
    valid = np.arange(tm)[None] < d["tlen"][:, None]
    for want, sem in zip(both(tokens, d["sem"]), (L(tokens), F32(d["sem"]))):
        with torch.no_grad():
            got = prs._s2a_step_ragged(pm, L(d["acoustic"]), torch.from_numpy(d["mask"]),
                                       L(d["tlen"]), L(layer), F32(t), sem, L(d["prompt_ac"]),
                                       L(d["plen"]), 1.5, 0.75)
        assert got.shape == (3, tm, 16)
        np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=1e-4)


def test_t2s_sample_ragged_matches_jax(sv):
    d = _sv_inputs(7)
    keys = _sv_keys([5, 6, 7], 1)
    t_max = SV_BUCKET[2]
    want = jrs.t2s_sample_ragged(sv["jax"]["t2s"], sv["trees"]["t2s"], d["prompt"], d["plen"],
                                 d["phone"], d["phlen"], d["tlen"], keys, t_max, **SV_T2S_KW)
    draws = t2s_draws(keys, SV_T2S_KW["n_steps"], t_max, 24)
    got = prs.t2s_sample_ragged(sv["t2s"], L(d["prompt"]), L(d["plen"]), L(d["phone"]),
                                L(d["phlen"]), L(d["tlen"]), [None] * 3, t_max,
                                gumbel=iter(draws), **SV_T2S_KW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(np.asarray(want)[0])) > 1  # the draws, not a constant, decided


def test_s2a_sample_ragged_matches_jax(sv):
    """Float (mel-proxy) conditioning; token conditioning is held in the
    step test above."""
    d = _sv_inputs(8)
    keys = _sv_keys([5, 6, 7], 2)
    t_max = SV_BUCKET[2]
    want = jrs.s2a_sample_ragged(sv["jax"]["s2a"], sv["trees"]["s2a"], d["sem"], d["prompt_ac"],
                                 d["plen"], d["tlen"], keys, t_max, **SV_S2A_KW)
    draws = s2a_draws(keys, 2, SV_S2A_KW["first_layer_steps"], 1, t_max, 16)
    got = prs.s2a_sample_ragged(sv["s2a"], F32(d["sem"]), L(d["prompt_ac"]), L(d["plen"]),
                                L(d["tlen"]), [None] * 3, t_max, gumbel=iter(draws),
                                **SV_S2A_KW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampler_generators_and_bf16(sv):
    """Without injected draws each request draws from its own generator: a
    row alone equals the same row in a batch; bf16 casts the float32
    parameters and still returns valid tokens, 0 past each target."""
    d = _sv_inputs(9)

    def run(rows, model, dtype="float32"):
        gens = [prs.maskgct_generators(70 + r, "cpu")[0] for r in rows]
        return prs.t2s_sample_ragged(model, L(d["prompt"][rows]), L(d["plen"][rows]),
                                     L(d["phone"][rows]), L(d["phlen"][rows]),
                                     L(d["tlen"][rows]), gens, SV_BUCKET[2], n_steps=3,
                                     compute_dtype=dtype)
    batch = run([0, 1, 2], sv["t2s"])
    np.testing.assert_array_equal(run([1], sv["t2s"]).numpy()[0], batch.numpy()[1])
    bf = from_flax(MaskGCTT2S(T2SConfig(**SV_T2S)), sv["trees"]["t2s"]).eval()
    out = run([0, 1, 2], bf, "bfloat16")
    assert bf.mask_emb.dtype == torch.bfloat16 and out.shape == (3, SV_BUCKET[2])
    assert int(out.max()) < 24 and (out.numpy()[0, d["tlen"][0]:] == 0).all()


def _features(audio: np.ndarray) -> np.ndarray:
    """A deterministic stand-in semantic extractor: 4 samples a frame (twice
    the codec's rate, as the served mel front end runs) through a fixed
    projection to 8 features."""
    n = max(len(audio) // 4, 1)
    frames = np.pad(audio, (0, 4 * n - len(audio)))[: 4 * n].reshape(n, 4)
    proj = np.random.default_rng(99).standard_normal((4, 8)).astype(np.float32)
    return np.tanh(frames @ proj * 3.0).astype(np.float32)


def _sv_audio(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(np.arange(n) * (0.3 + 0.05 * seed))
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _serve_all(svc):
    """The three requests at once, from threads; each must land in one batch."""
    out = {}

    def call(i, r):
        out[i] = svc.synthesize(_sv_audio(r[0], i), r[1], r[2], target_len=r[3], seed=r[4])
    threads = [threading.Thread(target=call, args=(i, r)) for i, r in enumerate(SV_REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return [out[i] for i in range(len(SV_REQUESTS))]


def test_service_matches_jax(sv, monkeypatch):
    """One batch of three mixed-length requests through the JAX
    `MaskGCTService` and the port's: semantic tokens and acoustic codes
    equal (the port given JAX's draws for each request's seed), waveforms
    within 1e-4, each cut to its target length."""
    from amphion_tpu.pipelines.maskgct_pipeline import MaskGCTPipeline as JPipeline
    from amphion_tpu.serving import service as jservice
    from amphion_tpu.text.symbol_table import SymbolTable as JSymbolTable
    from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec, CodecConfig
    from amphion_tpu_torch.models.codec.repcodec import RepCodec, RepCodecConfig
    from amphion_tpu_torch.pipelines.maskgct_pipeline import MaskGCTPipeline
    from amphion_tpu_torch.serving import service as pservice

    symbols = sorted({c for r in SV_REQUESTS for c in r[1] + r[2]})
    jm, trees = sv["jax"], sv["trees"]

    class JitPipeline(JPipeline):  # the front end jitted, as the served CLI would run it
        @functools.cached_property
        def _encoders(self):
            return (jax.jit(lambda f: jm["semantic_codec"].apply(
                        {"params": trees["semantic_codec"]}, f,
                        method=type(jm["semantic_codec"]).encode)),
                    jax.jit(lambda a: jm["acoustic_codec"].apply(
                        {"params": trees["acoustic_codec"]}, a,
                        method=type(jm["acoustic_codec"]).encode)))

        def extract_semantic_code(self, audio):
            return self._encoders[0](jnp.asarray(self.semantic_extractor(audio, 8000))[None])

        def extract_acoustic_code(self, audio):
            return self._encoders[1](jnp.asarray(audio)[None])

    jpipe = JitPipeline(**jm, params=trees, semantic_extractor=lambda a, sr: _features(a),
                        symbol_table=JSymbolTable.from_symbols(["_"] + symbols),
                        sample_rate=8000)
    states = {"t2s": sv["t2s"].state_dict(), "s2a": sv["s2a"].state_dict(),
              "semantic_codec": from_flax(RepCodec(RepCodecConfig(**SV_SEM), with_decode=True),
                                          trees["semantic_codec"]).state_dict(),
              "acoustic_codec": from_flax(AmphionCodec(CodecConfig(**SV_CODEC)),
                                          trees["acoustic_codec"]).state_dict()}
    ppipe = MaskGCTPipeline.build(
        T2SConfig(**SV_T2S), S2AConfig(**SV_S2A), RepCodecConfig(**SV_SEM),
        CodecConfig(**SV_CODEC), states, "cpu", "float32",
        semantic_extractor=lambda a: torch.from_numpy(_features(a.numpy())),
        symbol_table=SymbolTable.from_symbols(["_"] + symbols), sample_rate=8000)
    assert not ppipe.token_cond

    seen = {"jax": [], "port": []}

    def rows(target_len, out):  # the batch's rows in request order (distinct lengths)
        return np.asarray(out)[np.argsort(np.asarray(target_len))]

    def recording(fn, key):
        def run(*a, **kw):
            out = fn(*a, **kw)
            seen[key].append(rows(a[-3], out))
            return out
        return run
    monkeypatch.setattr(jservice, "t2s_sample_ragged",
                        recording(jservice.t2s_sample_ragged, "jax"))
    monkeypatch.setattr(jservice, "s2a_sample_ragged",
                        recording(jservice.s2a_sample_ragged, "jax"))

    # the port draws JAX's noise of each request's seed (generators stand for seeds here)
    def injected(fn, stage):
        def run(model, *a, **kw):
            seeds, t_max = list(a[-2]), a[-1]
            keys = _sv_keys(seeds, stage)
            draws = (t2s_draws(keys, kw["n_steps"], t_max, 24) if stage == 1 else
                     s2a_draws(keys, 2, kw["first_layer_steps"], 1, t_max, 16))
            out = fn(model, *a[:-2], [None] * len(seeds), t_max, gumbel=iter(draws), **kw)
            seen["port"].append(rows(a[-3], out))
            return out
        return run
    monkeypatch.setattr(pservice, "maskgct_generators", lambda seed, dev: (seed, seed))
    monkeypatch.setattr(pservice, "t2s_sample_ragged", injected(prs.t2s_sample_ragged, 1))
    monkeypatch.setattr(pservice, "s2a_sample_ragged", injected(prs.s2a_sample_ragged, 2))

    jsvc = jservice.MaskGCTService(jpipe, **SV_SERVICE, t2s_kwargs=SV_T2S_KW,
                                   s2a_kwargs=SV_S2A_KW)
    psvc = pservice.MaskGCTService(ppipe, **SV_SERVICE, t2s_kwargs=SV_T2S_KW,
                                   s2a_kwargs=SV_S2A_KW)
    try:
        want, got = _serve_all(jsvc), _serve_all(psvc)
        assert jsvc.stats()["max_batch"] == psvc.stats()["max_batch"] == 3
    finally:
        jsvc.batcher.shutdown()
        psvc.shutdown()
    assert len(seen["jax"]) == len(seen["port"]) == 2
    for j, p in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(p, j)
    hop = 8
    for r, w, g in zip(SV_REQUESTS, want, got):
        assert w.shape == g.shape == (r[3] * hop,)
        np.testing.assert_allclose(g, w, atol=1e-4)
    assert np.abs(want[0]).max() > 1e-3
