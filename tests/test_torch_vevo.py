"""PyTorch port, the Vevo-Timbre and Vevo-Voice slices: flow-matching
inference (fixed-shape and ragged), the whole serving paths (style tokens →
FM → Vocos; content tokens → AR → FM → Vocos) and the service's batch
invariance, against the JAX package on the CPU.

Noise is made with numpy (or by the port's own generator) and injected
into the JAX path with ``noise=``. Tolerances: 1e-4 absolute in float32,
2e-4 for the ragged FM (as tests/test_ragged_vevo.py), 3e-2 relative in
bfloat16; tokens exact. ``flow_eval``'s std is the population std
(``jnp.std``, ``unbiased=False`` in torch).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amphion_tpu.models.codec.repcodec import RepCodec as JRepCodec
from amphion_tpu.models.codec.repcodec import RepCodecConfig as JRepCodecConfig
from amphion_tpu.models.vc.ar_transformer import ARTransformer as JAR
from amphion_tpu.models.vc.ar_transformer import ARTransformerConfig as JARConfig
from amphion_tpu.models.vc.ar_transformer import (
    ar_transformer_generate_ragged as jax_ar_ragged,
)
from amphion_tpu.models.vc.flow_matching_transformer import FlowMatchingTransformer as JFMT
from amphion_tpu.models.vc.flow_matching_transformer import FMTConfig as JFMTConfig
from amphion_tpu.models.vc.flow_matching_transformer import fmt_inference as jax_fmt
from amphion_tpu.models.vc.flow_matching_transformer import (
    fmt_inference_ragged as jax_fmt_ragged,
)
from amphion_tpu.models.vocoders.vocos import VocosConfig as JVocosConfig
from amphion_tpu.models.vocoders.vocos import VocosGenerator as JVocos
from amphion_tpu.ops.mel import MelConfig as JMelConfig
from amphion_tpu.ops.mel import mel_spectrogram as jax_mel
from amphion_tpu.pipelines.vevo_pipeline import VevoPipeline as JVevoPipeline
from amphion_tpu.serving.service import VevoService as JVevoService
from amphion_tpu_torch.models.codec.repcodec import RepCodec, RepCodecConfig
from amphion_tpu_torch.models.vc.ar_transformer import (
    ARTransformer,
    ARTransformerConfig,
    ar_transformer_generate_ragged,
    prepare_for_decode,
)
from amphion_tpu_torch.models.vc.flow_matching_transformer import (
    FlowMatchingTransformer,
    FMTConfig,
    fmt_inference,
    fmt_inference_ragged,
    prepare_for_inference,
)
from amphion_tpu_torch.models.vocoders.vocos import VocosConfig, VocosGenerator
from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram
from amphion_tpu_torch.pipelines.vevo_pipeline import VevoPipeline
from amphion_tpu_torch.serving.service import VevoService, voice_generators
from amphion_tpu_torch.utils.convert import from_flax

# the suite runs one worker process per core: torch's own threads would oversubscribe them
torch.set_num_threads(1)


T = torch.from_numpy
FM = dict(token_vocab=64, n_mel=8, hidden=32, num_layers=2, num_heads=2,
          max_position=512)
TOK = dict(feature_dim=8, hidden=16, codebook_size=64, codebook_dim=4, num_blocks=1)
VOC = dict(n_mel=8, dim=16, intermediate_dim=32, num_layers=1, n_fft=64, hop_size=32)
MEL = dict(sample_rate=16000, n_fft=64, win_size=64, hop_size=32, n_mel=8,
           fmax=8000.0)


def jfill(module, seed, *args, **kw):
    """A Flax tree of ``module``'s shapes (``jax.eval_shape`` of its
    ``init``: traced, not compiled) filled from a numpy seed: kernels normal
    over √fan_in, biases and ConvNeXt gammas small, norm scales in [0.5,
    1.5], embeddings normal over √features, codebooks normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("bias", "gamma"):
            std = 0.1
        elif name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        elif name == "embedding":
            std = 1.0 / np.sqrt(s.shape[-1])
        else:
            std = 1.0
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    shapes = jax.eval_shape(functools.partial(module.init, **kw), *args)["params"]
    return jax.tree_util.tree_map_with_path(leaf, shapes)


class JitApply:
    """A Flax module whose ``apply`` runs under one jit per method, as a
    served front end runs it (eager Flax dispatches op by op: seconds a call
    on the CPU); every other attribute is the module's."""

    def __init__(self, module):
        self.module, self._fns = module, {}

    def apply(self, variables, *args, method=None):
        if method not in self._fns:
            self._fns[method] = jax.jit(
                lambda v, *a: self.module.apply(v, *a, method=method))
        return self._fns[method](variables, *args)

    def __getattr__(self, name):
        return getattr(self.module, name)


@pytest.fixture(scope="module")
def fm_pair():
    jm = JFMT(JFMTConfig(**FM))
    tok = jnp.zeros((1, 10), jnp.int32)
    pmask = jnp.concatenate([jnp.ones((1, 4)), jnp.zeros((1, 6))], axis=1)
    params = jfill(jm, 7, jax.random.key(0), jnp.zeros((1, 10, 8)), tok, pmask,
                   jnp.ones((1, 10)), jax.random.key(1), method=JFMT.loss)
    return jm, params, from_flax(FlowMatchingTransformer(FMTConfig(**FM)), params)


@pytest.mark.parametrize("solver,cfg", [("euler", 0.0), ("midpoint", 1.5)])
def test_fmt_inference_matches_jax(fm_pair, solver, cfg):
    jm, params, tm = fm_pair
    rng = np.random.default_rng(11)
    b, lp, lt = 2, 5, 9
    tokens = rng.integers(0, 64, (b, lp + lt)).astype(np.int32)
    pmel = (rng.standard_normal((b, lp, 8)) * 0.5).astype(np.float32)
    noise = rng.standard_normal((b, lt, 8)).astype(np.float32)
    ref = jax_fmt(jm, params, jnp.asarray(tokens), jnp.asarray(pmel), None,
                  num_steps=3, cfg_scale=cfg, compute_dtype="float32",
                  noise=jnp.asarray(noise), solver=solver)
    out = fmt_inference(tm, T(tokens), T(pmel), num_steps=3, cfg_scale=cfg,
                        compute_dtype="float32", noise=T(noise), solver=solver)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("solver,cfg", [("euler", 1.5), ("midpoint", 0.0)])
def test_fmt_inference_ragged_matches_jax(fm_pair, solver, cfg):
    jm, params, tm = fm_pair
    rng = np.random.default_rng(12)
    ptok = rng.integers(0, 64, (3, 6)).astype(np.int32)
    ttok = rng.integers(0, 64, (3, 9)).astype(np.int32)
    plen, tlen = np.array([4, 6, 2], np.int32), np.array([9, 5, 7], np.int32)
    pmel = (rng.standard_normal((3, 6, 8)) * 0.5).astype(np.float32)
    noise = rng.standard_normal((3, 9, 8)).astype(np.float32)
    ref = np.asarray(jax_fmt_ragged(
        jm, params, ptok, plen, ttok, tlen, pmel, None, num_steps=3,
        cfg_scale=cfg, compute_dtype="float32", noise=jnp.asarray(noise),
        solver=solver))
    out = fmt_inference_ragged(
        tm, T(ptok), T(plen), T(ttok), T(tlen), T(pmel), num_steps=3,
        cfg_scale=cfg, compute_dtype="float32", noise=T(noise), solver=solver).numpy()
    for i, n in enumerate(tlen):
        np.testing.assert_allclose(out[i, :n], ref[i, :n], atol=2e-4)
        assert not out[i, n:].any()


def test_fmt_inference_bf16_matches_jax(fm_pair):
    jm, params, _ = fm_pair
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, 64, (1, 12)).astype(np.int32)
    pmel = (rng.standard_normal((1, 4, 8)) * 0.5).astype(np.float32)
    noise = rng.standard_normal((1, 8, 8)).astype(np.float32)
    ref = np.asarray(jax_fmt(jm, params, jnp.asarray(tokens), jnp.asarray(pmel), None,
                             num_steps=3, compute_dtype="bfloat16",
                             noise=jnp.asarray(noise)))
    tm16 = from_flax(FlowMatchingTransformer(FMTConfig(**FM)), params).bfloat16()
    out = fmt_inference(tm16, T(tokens), T(pmel), num_steps=3,
                        compute_dtype="bfloat16", noise=T(noise)).numpy()
    assert np.abs(out - ref).max() <= 3e-2 * np.abs(ref).max()


@pytest.mark.parametrize("quant", ["int8"])
def test_fmt_inference_quantized_matches_jax(fm_pair, quant):
    """Quantized estimator projections (kernel 4, bf16 activations; kernel
    5 goes through the same preparation, tests/test_torch_quant.py holds it):
    the port quantizes its own weights at preparation, JAX inside its jit."""
    jm, params, _ = fm_pair
    rng = np.random.default_rng(15)
    tokens = rng.integers(0, 64, (1, 12)).astype(np.int32)
    pmel = (rng.standard_normal((1, 4, 8)) * 0.5).astype(np.float32)
    noise = rng.standard_normal((1, 8, 8)).astype(np.float32)
    ref = np.asarray(jax_fmt(jm, params, jnp.asarray(tokens), jnp.asarray(pmel), None,
                             num_steps=1, compute_dtype=quant, noise=jnp.asarray(noise)))
    tq = prepare_for_inference(from_flax(FlowMatchingTransformer(FMTConfig(**FM)), params),
                               quant)
    assert tq.cfg.decode_quant == quant
    out = fmt_inference(tq, T(tokens), T(pmel), num_steps=1, compute_dtype=quant,
                        noise=T(noise)).numpy()
    assert np.abs(out - ref).max() <= 3e-2 * np.abs(ref).max()


def test_velocity_matches_jax(fm_pair):
    """The training-time flow: prompt frames enter clean, pad keys masked,
    condition dropped on request."""
    jm, params, tm = fm_pair
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 10, 8)).astype(np.float32)
    mel = rng.standard_normal((2, 10, 8)).astype(np.float32)
    tokens = rng.integers(0, 64, (2, 10)).astype(np.int32)
    t = np.array([0.3, 0.8], np.float32)
    pmask = (np.arange(10)[None] < np.array([[3], [5]])).astype(np.float32)
    xmask = (np.arange(10)[None] < np.array([[10], [8]])).astype(np.float32)
    for drop in (False, True):
        ref = np.asarray(jax.jit(functools.partial(
            jm.apply, method=JFMT.velocity, drop_cond=drop))(
            {"params": params}, x, t, tokens, mel, pmask, xmask))
        with torch.no_grad():
            out = tm.velocity(T(x), T(t), T(tokens).long(), T(mel), T(pmask),
                              T(xmask), drop_cond=drop).numpy()
        valid = xmask > 0
        np.testing.assert_allclose(out[valid], ref[valid], atol=1e-4)


def test_fmt_inference_rejects_bad_solver_and_dtype(fm_pair):
    _, _, tm = fm_pair
    tok, pm = torch.zeros((1, 6), dtype=torch.long), torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="solver"):
        fmt_inference(tm, tok, pm, num_steps=1, compute_dtype="float32", solver="rk4")
    with pytest.raises(ValueError, match="cast it once"):
        fmt_inference(tm, tok, pm, num_steps=1, compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def timbre_pair(fm_pair):
    """The JAX Vevo pipeline and its port, sharing weights."""
    jm, fm_params, _ = fm_pair
    feats = jnp.zeros((1, 20, 8))
    jtok = JRepCodec(JRepCodecConfig(**TOK))
    tok_params = jfill(jtok, 8, jax.random.key(2), feats)
    jvoc = JVocos(JVocosConfig(**VOC))
    voc_params = jfill(jvoc, 9, jax.random.key(3), feats)
    jmel_cfg = JMelConfig(**MEL)
    mel_jit = jax.jit(lambda a: jax_mel(a, jmel_cfg))

    def jssl(audio, sr):
        t = len(audio) // jmel_cfg.hop_size * jmel_cfg.hop_size
        return np.asarray(mel_jit(jnp.asarray(audio[:t])[None]))[0].T

    jpipe = JVevoPipeline(
        content_tokenizer=None, style_tokenizer=JitApply(jtok), ar=None, fm=jm, vocoder=jvoc,
        params={"style_tokenizer": tok_params, "fm": fm_params, "vocoder": voc_params},
        hubert_extractor=jssl, mel_cfg=jmel_cfg)
    mel_cfg = MelConfig(**MEL)
    pipe = VevoPipeline(
        style_tokenizer=from_flax(RepCodec(RepCodecConfig(**TOK)), tok_params),
        fm=from_flax(FlowMatchingTransformer(FMTConfig(**FM)), fm_params),
        vocoder=from_flax(VocosGenerator(VocosConfig(**VOC)), voc_params),
        ssl_extractor=lambda a: mel_spectrogram(
            a[: len(a) // mel_cfg.hop_size * mel_cfg.hop_size][None], mel_cfg)[0].T,
        mel_cfg=mel_cfg, compute_dtype="float32")
    return jpipe, pipe


def _audio(seed, seconds):
    t = np.arange(int(16000 * seconds)) / 16000.0
    rng = np.random.default_rng(seed)
    tone = np.sin(2 * np.pi * (180 + 40 * seed) * t) * (0.5 + 0.5 * np.sin(3 * t))
    return (0.3 * tone + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def test_timbre_service_matches_jax_slice(timbre_pair):
    """One request through the port's VevoService against the JAX
    VevoService front end, `fmt_inference_ragged` and Vocos, with the port's
    noise injected into the JAX ODE."""
    jpipe, pipe = timbre_pair
    src, ref_audio, seed = _audio(1, 0.9), _audio(2, 0.6), 5
    kw = dict(len_step=8, max_prompt_len=64, max_new=64, flow_matching_steps=3,
              audio_grid_s=0.25)
    svc, jsvc = VevoService(pipe, **kw), JVevoService(jpipe, **kw)
    try:
        wav = svc.synthesize(src, ref_audio, seed=seed)
        req = svc._prepare_request(src, ref_audio, "timbre", seed)
        jreq = jsvc._prepare_request(src, ref_audio, "timbre", seed)
    finally:
        svc.shutdown()
        jsvc.batcher.shutdown()
    np.testing.assert_array_equal(req.target_style.numpy(), jreq.target_style)
    np.testing.assert_array_equal(req.fm_prompt_tokens.numpy(), jreq.fm_prompt_tokens)
    np.testing.assert_allclose(req.fm_prompt_mel.numpy(), jreq.fm_prompt_mel, atol=1e-3)
    bucket = svc._bucket_of(req)
    assert bucket == jsvc._bucket_of(jreq)
    _, (lt_tok,), lp_tok = bucket
    noise = torch.randn((lt_tok, 8), generator=torch.Generator().manual_seed(seed))
    lp, lt = len(jreq.fm_prompt_tokens), len(jreq.target_style)
    mel = jax_fmt_ragged(
        jpipe.fm, jpipe.params["fm"],
        np.pad(jreq.fm_prompt_tokens, (0, lp_tok - lp))[None], np.array([lp]),
        np.pad(jreq.target_style, (0, lt_tok - lt))[None], np.array([lt]),
        np.pad(jreq.fm_prompt_mel, ((0, lp_tok - lp), (0, 0)))[None], None,
        num_steps=3, compute_dtype="float32", noise=jnp.asarray(noise.numpy()[None]))
    jwav = np.asarray(jsvc._voc_jit(jpipe.params["vocoder"], mel,
                                    jnp.asarray([lt])))[0, : lt * 32]
    assert wav.shape == jwav.shape == (len(req.target_style) * 32,)
    assert np.abs(jwav).max() > 1e-3
    np.testing.assert_allclose(wav, jwav, atol=2e-4)


def test_timbre_service_batch_invariance(timbre_pair):
    """A request gives the same waveform alone as in a batch of three."""
    _, pipe = timbre_pair
    kw = dict(len_step=64, max_prompt_len=64, max_new=64, flow_matching_steps=2)
    svc = VevoService(pipe, max_batch=3, max_wait_ms=5000, **kw)
    alone = VevoService(pipe, max_batch=1, max_wait_ms=0, **kw)
    try:
        reqs = [svc._prepare_request(_audio(i, 0.5 + 0.2 * i), _audio(9 - i, 0.5),
                                     "timbre", 100 + i) for i in range(3)]
        assert len({svc._bucket_of(r) for r in reqs}) == 1
        futures = [svc.batcher.submit(r) for r in reqs]
        batched = [f.result(timeout=60) for f in futures]
        solo = [alone.batcher.submit(r).result(timeout=60) for r in reqs]
        with pytest.raises(ValueError, match="AR stage"):  # a timbre-only pipeline
            svc.synthesize(_audio(0, 0.5), _audio(1, 0.5), mode="voice")
    finally:
        svc.shutdown()
        alone.shutdown()
    assert svc.stats()["max_batch"] == 3
    for a, b, r in zip(batched, solo, reqs):
        assert a.shape == (len(r.target_style) * 32,) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1e-5)


AR = dict(input_vocab=8, output_vocab=64, hidden=32, intermediate=64, num_layers=2,
          num_heads=2, max_position=1024)
CTOK = dict(TOK, codebook_size=8)
VOICE = dict(len_step=256, max_content_len=256, max_prompt_len=64, max_new=10,
             flow_matching_steps=2, audio_grid_s=0.25)


@pytest.fixture(scope="module")
def voice_pair(timbre_pair):
    """The timbre pair plus a content tokenizer (vocab 8) and an AR."""
    jpipe, pipe = timbre_pair
    jctok = JRepCodec(JRepCodecConfig(**CTOK))
    ctok_params = jfill(jctok, 10, jax.random.key(4), jnp.zeros((1, 20, 8)))
    jar = JAR(JARConfig(**AR))
    toks = jnp.zeros((1, 5), jnp.int32)
    ar_params = jfill(jar, 11, jax.random.key(5), toks, jnp.ones((1, 5)), toks,
                      jnp.ones((1, 5)), method=JAR.forward)
    jvoice = JVevoPipeline(
        content_tokenizer=JitApply(jctok), style_tokenizer=jpipe.style_tokenizer, ar=jar,
        fm=jpipe.fm, vocoder=jpipe.vocoder,
        params={**jpipe.params, "content_tokenizer": ctok_params, "ar": ar_params},
        hubert_extractor=jpipe.hubert_extractor, mel_cfg=jpipe.mel_cfg)
    voice = dataclasses.replace(
        pipe, content_tokenizer=from_flax(RepCodec(RepCodecConfig(**CTOK)), ctok_params),
        ar=prepare_for_decode(from_flax(ARTransformer(ARTransformerConfig(**AR)), ar_params),
                              "float32"))
    return jvoice, voice


def test_voice_service_matches_jax_slice(voice_pair):
    """One Vevo-Voice request, greedy, float32: the port's front end (content
    tokens of [ref ‖ src], the style prompt), its ragged AR decode (tokens
    exact) and its FM + Vocos (the port's noise injected into JAX) against
    the JAX VevoService's."""
    jpipe, pipe = voice_pair
    src, ref_audio, seed = _audio(3, 0.3), _audio(4, 0.25), 7
    svc = VevoService(pipe, temperature=0.0, **VOICE)
    jsvc = JVevoService(jpipe, temperature=0.0, compute_dtype="float32", **VOICE)
    try:
        wav = svc.synthesize(src, ref_audio, mode="voice", seed=seed)
        req = svc._prepare_request(src, ref_audio, "voice", seed)
        jreq = jsvc._prepare_request(src, ref_audio, "voice", seed)
    finally:
        svc.shutdown()
        jsvc.batcher.shutdown()
    np.testing.assert_array_equal(req.content.numpy(), jreq.content)
    np.testing.assert_array_equal(req.prompt_out.numpy(), jreq.prompt_out)
    np.testing.assert_array_equal(req.fm_prompt_tokens.numpy(), jreq.fm_prompt_tokens)
    bucket = svc._bucket_of(req)
    assert bucket == jsvc._bucket_of(jreq)
    _, (lc, lo), lp_tok = bucket
    pad = lambda a, n: np.pad(a, (0, n - len(a)))[None]  # noqa: E731
    jt, jn = jax_ar_ragged(
        jpipe.ar, jpipe.params["ar"], pad(jreq.content, lc), np.array([len(jreq.content)]),
        jax.vmap(jax.random.key)(jnp.zeros((1,), jnp.uint32)), max_new=10, temperature=0.0,
        prompt_output_tokens=pad(jreq.prompt_out, lo),
        prompt_output_len=np.array([len(jreq.prompt_out)]), compute_dtype="float32")
    tt, tn = ar_transformer_generate_ragged(
        pipe.ar, T(pad(req.content.numpy(), lc)), torch.tensor([len(req.content)]), None,
        max_new=10, temperature=0.0, prompt_output_tokens=T(pad(req.prompt_out.numpy(), lo)),
        prompt_output_len=torch.tensor([len(req.prompt_out)]), compute_dtype="float32")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    lt = max(int(jn[0]), 1)
    noise = torch.randn((10, 8), generator=voice_generators(seed, "cpu")[1])
    lp = len(jreq.fm_prompt_tokens)
    mel = jax_fmt_ragged(
        jpipe.fm, jpipe.params["fm"], pad(jreq.fm_prompt_tokens, lp_tok), np.array([lp]),
        np.asarray(jt)[:, :10], np.array([lt]),
        np.pad(jreq.fm_prompt_mel, ((0, lp_tok - lp), (0, 0)))[None], None, num_steps=2,
        compute_dtype="float32", noise=jnp.asarray(noise.numpy()[None]))
    jwav = np.asarray(jsvc._voc_jit(jpipe.params["vocoder"], mel,
                                    jnp.asarray([lt])))[0, : lt * 32]
    assert wav.shape == jwav.shape == (lt * 32,)
    np.testing.assert_allclose(wav, jwav, atol=2e-4)


def test_voice_service_batch_invariance(voice_pair):
    """Sampled voice requests (temperature 1, top-k 5) give the same
    waveform alone (a batch of one, its decode padded to max_batch rows) as
    in a batch of three."""
    _, pipe = voice_pair
    svc = VevoService(pipe, max_batch=3, max_wait_ms=5000, top_k=5, **VOICE)
    alone = VevoService(pipe, max_batch=3, max_wait_ms=0, top_k=5, **VOICE)
    try:
        reqs = [svc._prepare_request(_audio(i, 0.2 + 0.05 * i), _audio(5 + i, 0.25),
                                     "voice", 30 + i) for i in range(3)]
        assert len({svc._bucket_of(r) for r in reqs}) == 1
        futures = [svc.batcher.submit(r) for r in reqs]
        batched = [f.result(timeout=60) for f in futures]
        solo = [alone.batcher.submit(r).result(timeout=60) for r in reqs]
    finally:
        svc.shutdown()
        alone.shutdown()
    assert svc.stats()["max_batch"] == 3
    for a, b in zip(batched, solo):
        assert a.ndim == 1 and len(a) % 32 == 0 and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1e-5)
