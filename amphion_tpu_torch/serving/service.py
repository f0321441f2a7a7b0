"""Batched serving (port of `MaskGCTService`, `VALLEService` and
`VevoService`, `amphion_tpu/serving/service.py:74-215`, `:212-318` and
`:328-510`, the window batcher). `MaskGCTService` and `VALLEService` are
described in their classes; the rest of this text is about Vevo.

Concurrent `synthesize` calls run their front end (mel, tokens, the prompt
mel) in the caller's thread, one at a time, and are coalesced by
`MicroBatcher` into length-bucketed batches. Two products:

- ``mode="timbre"`` (Vevo-Timbre): the source's style tokens re-rendered
  with the reference's timbre: the ragged FM ODE (`fmt_inference_ragged`)
  and a length-masked Vocos decode, once per batch.
- ``mode="voice"`` (Vevo-Voice): the AR first rewrites the content of
  [reference ‖ source] in the reference's style (a ragged, style-prompted
  decode, `ar_transformer_generate_ragged`), then the FM and Vocos.

Each request draws from its own ``torch.Generator``s seeded from its
``seed`` (timbre: the FM noise from ``seed``; voice: the AR's tokens from
``2 * seed + 1`` and the FM noise from ``2 * seed + 2``), so a request's
tokens do not depend on the batch it lands in (its waveform only within the
flow matching's float tolerance). Under int8/int4 the decode is
row-invariant on the card up to 8 rows (projections on the GEMV path,
``lm_head``, norms and attention products computed row by row); under
float32/bf16 its cuBLAS products are not, and the decode runs
``max_batch`` rows whatever the batch holds, as it does under int8/int4
when ``max_batch`` exceeds 8 (the projections' GEMM path, whose rows do not
depend on their number but differ from the GEMV's).

`serving/continuous_service.VevoContinuousService` and
`ValleContinuousService` replace the dispatch (`_init_dispatch`) and reuse
the front end and the tail.
"""

from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from amphion_tpu_torch.models.tts.maskgct.ragged_sampling import (
    maskgct_generators,
    pack_prefix_target,
    s2a_sample_ragged,
    t2s_sample_ragged,
)
from amphion_tpu_torch.models.tts.valle.valle import (
    nar_generate_ragged,
    prepare_for_decode,
    valle_generate_ragged,
)
from amphion_tpu_torch.models.vc.ar_transformer import ar_transformer_generate_ragged
from amphion_tpu_torch.models.vc.flow_matching_transformer import fmt_inference_ragged
from amphion_tpu_torch.ops.kernels.int8_matmul import GEMV_MAX_M
from amphion_tpu_torch.serving.batcher import MicroBatcher, bucket_ladder


def _pad_to(x: torch.Tensor, length: int) -> torch.Tensor:
    """Zero-pad axis 0 of ``x`` up to ``length``."""
    pad = [0, 0] * (x.ndim - 1) + [0, length - x.shape[0]]
    return F.pad(x, pad)


def _pad_audio_grid(audio: torch.Tensor, sr: int, grid_s: float) -> torch.Tensor:
    """Pad request audio with trailing silence up to a ``grid_s``-second
    grid, which bounds the number of distinct front-end shapes
    (``grid_s <= 0`` disables)."""
    if grid_s <= 0:
        return audio
    g = max(int(grid_s * sr), 1)
    m = max(g, -(-len(audio) // g) * g)
    return F.pad(audio, (0, m - len(audio)))


@dataclass
class _MaskGCTCoreRequest:
    prompt_semantic: torch.Tensor  # (Lp,) int
    prompt_acoustic: torch.Tensor  # (Q, Lp) int
    phone_ids: torch.Tensor  # (Lph,) int
    target_len: int
    seed: int


class MaskGCTService:
    """Thread-safe batched MaskGCT synthesis around a `MaskGCTPipeline`.

    Concurrent `synthesize` calls run their front end (g2p, the semantic
    tokens, the prompt's acoustic codes) in the caller's thread, one at a
    time, after padding the prompt to a 0.5 s grid (``audio_grid_s``), and
    are coalesced by `MicroBatcher` into batches of one bucket: prompt,
    phone and target lengths each quantized onto a ladder of ``len_step``.
    A batch runs the ragged T2S, the ragged S2A (conditioned on semantic
    tokens when the S2A's checkpoint holds ``cond_emb``, else on the
    semantic codec's decoded latents) and one length-masked codec decode,
    each request cut to its ``target_len`` frames. Each request draws from
    its own generators (`maskgct_generators`), so its tokens do not depend on
    its company. ``t2s_kwargs``/``s2a_kwargs`` go to the samplers (the
    pipeline's ``compute_dtype`` unless they name one).

    As in the JAX package, the semantic tokens run at ``sample_rate / mel
    hop`` (200 Hz on the served config) while the codec runs at
    ``sample_rate / hop`` (100 Hz): the prompt is cut to the codec's frame
    count, and a target of N frames decodes to N codec frames.
    """

    def __init__(self, pipeline, max_batch: int = 8, max_wait_ms: float = 50.0,
                 len_step: int = 64, max_prompt_len: int = 512,
                 max_target_len: int = 1024, max_phone_len: int = 512,
                 t2s_kwargs: dict | None = None, s2a_kwargs: dict | None = None,
                 audio_grid_s: float = 0.5):
        self.pipeline = pipeline
        self.audio_grid_s = audio_grid_s
        self.len_step = len_step
        self.max_prompt_len = max_prompt_len
        self.max_target_len = max_target_len
        self.max_phone_len = max_phone_len
        dtype = {"compute_dtype": pipeline.compute_dtype}
        self.t2s_kwargs = {**dtype, **(t2s_kwargs or {})}
        self.s2a_kwargs = {**dtype, **(s2a_kwargs or {})}
        self._frontend_lock = threading.Lock()
        self.batcher = MicroBatcher(self._run_batch, self._bucket_of,
                                    max_batch=max_batch, max_wait_ms=max_wait_ms)

    def _bucket_of(self, req: _MaskGCTCoreRequest):
        return (bucket_ladder(len(req.prompt_semantic), self.len_step, self.max_prompt_len),
                bucket_ladder(len(req.phone_ids), self.len_step, self.max_phone_len),
                bucket_ladder(req.target_len, self.len_step, self.max_target_len))

    def synthesize(self, prompt_audio, prompt_text: str, target_text: str,
                   target_len: int | None = None, seed: int = 0) -> np.ndarray:
        """Blocking single request; batches with concurrent callers. Returns
        the waveform as float32 numpy."""
        return self.batcher(self._prepare_request(prompt_audio, prompt_text, target_text,
                                                  target_len, seed))

    @torch.inference_mode()
    def _prepare_request(self, prompt_audio, prompt_text, target_text, target_len,
                         seed) -> _MaskGCTCoreRequest:
        p = self.pipeline
        audio = _pad_audio_grid(p.audio(prompt_audio), p.sample_rate, self.audio_grid_s)
        with self._frontend_lock:
            if p.symbol_table is None:
                p.symbol_table = p.g2p.build_symbol_table([prompt_text, target_text])
            phones_prompt = p.g2p.to_ids(prompt_text, p.symbol_table)
            phones_target = p.g2p.to_ids(target_text, p.symbol_table)
            prompt_semantic = p.extract_semantic_code(audio)[0]
            prompt_acoustic = p.extract_acoustic_code(audio)[:, 0]  # (Q, Lp)
        lp = min(len(prompt_semantic), prompt_acoustic.shape[1], self.max_prompt_len)
        if target_len is None:
            ratio = max(len(phones_target), 1) / max(len(phones_prompt), 1)
            target_len = int(lp * ratio) + 1
        target_len = min(int(target_len), self.max_target_len)
        phone_ids = torch.tensor(phones_prompt + phones_target, dtype=torch.long,
                                 device=audio.device)
        return _MaskGCTCoreRequest(prompt_semantic[:lp], prompt_acoustic[:, :lp],
                                   phone_ids[: self.max_phone_len], target_len, seed)

    def stats(self) -> dict:
        return self.batcher.stats.snapshot()

    def shutdown(self) -> None:
        self.batcher.shutdown()

    @torch.inference_mode()
    def _run_batch(self, bucket, reqs: list[_MaskGCTCoreRequest]) -> list[np.ndarray]:
        lp_max, lph_max, t_max = bucket
        p = self.pipeline
        dev = p.device

        def lengths(vals):
            return torch.tensor(vals, dtype=torch.long, device=dev)

        prompt_sem = torch.stack([_pad_to(r.prompt_semantic, lp_max) for r in reqs])
        prompt_ac = torch.stack([_pad_to(r.prompt_acoustic.T, lp_max).T for r in reqs])
        phones = torch.stack([_pad_to(r.phone_ids, lph_max) for r in reqs])
        prompt_len = lengths([len(r.prompt_semantic) for r in reqs])
        phone_len = lengths([len(r.phone_ids) for r in reqs])
        target_len = lengths([r.target_len for r in reqs])
        gens = [maskgct_generators(r.seed, dev) for r in reqs]
        semantic = t2s_sample_ragged(p.t2s, prompt_sem, prompt_len, phones, phone_len,
                                     target_len, [g[0] for g in gens], t_max,
                                     **self.t2s_kwargs)  # (B, t_max)
        sem_packed = pack_prefix_target(prompt_sem, semantic, prompt_len)
        if not p.token_cond:  # mel-proxy checkpoints condition on codec latents
            sem_packed = p.semantic_codec.decode_tokens(sem_packed)
        codes = s2a_sample_ragged(p.s2a, sem_packed, prompt_ac, prompt_len, target_len,
                                  [g[1] for g in gens], t_max,
                                  **self.s2a_kwargs)  # (B, Q, t_max)
        wav = p.codec_decode(codes, target_len).float().cpu().numpy()  # (B, samples)
        samples_per_frame = wav.shape[-1] / t_max
        return [wav[i, : int(round(r.target_len * samples_per_frame))]
                for i, r in enumerate(reqs)]


@dataclass
class _ValleCoreRequest:
    phone_ids: torch.Tensor  # (Lph,) int
    prompt_codes: torch.Tensor  # (Q, Lp) int
    seed: int


class VALLEService:
    """Thread-safe batched zero-shot VALL-E synthesis: AR, NAR and the codec
    decode.

    Concurrent `synthesize` calls run their front end (the prompt padded to
    a 0.5 s grid, g2p of ``prompt_text + " " + target_text`` cut to
    ``max_phone_len``, the prompt's codec codes cut to ``max_prompt_len``)
    in the caller's thread, one at a time, and are coalesced by
    `MicroBatcher` into batches of one (phone, prompt) bucket on ladders of
    ``len_step``. A batch runs `valle_generate_ragged` (the AR right-aligned,
    ``max_new`` steps; the NAR compact, greedy) and one length-masked codec
    decode; each request is cut to its own ``gen_len`` frames (at least
    one). Each request draws from a ``torch.Generator`` seeded with its
    seed, so its tokens do not depend on its company wherever the decode
    step's arithmetic does not depend on the batch's rows (float32 on the
    CPU; int8/int4 on the card up to 8 rows; not bf16 cuBLAS products).

    ``model`` is prepared for ``compute_dtype`` here
    (`valle.prepare_for_decode`: float32/bf16 cast it in place)."""

    def __init__(self, model, tokenizer, g2p, symbol_table, max_batch: int = 8,
                 max_wait_ms: float = 50.0, len_step: int = 64, max_phone_len: int = 256,
                 max_prompt_len: int = 512, max_new: int = 768, temperature: float = 1.0,
                 top_k: int = 50, compute_dtype: str = "bfloat16",
                 audio_grid_s: float = 0.5):
        self.model = prepare_for_decode(model, compute_dtype)
        self.tokenizer = tokenizer  # utils/tokenizer.AudioTokenizer
        self.g2p, self.symbol_table = g2p, symbol_table
        self.audio_grid_s = audio_grid_s
        self.len_step = len_step
        self.max_phone_len = max_phone_len
        self.max_prompt_len = max_prompt_len
        self.max_new = max_new
        self.temperature, self.top_k = temperature, top_k
        self.compute_dtype = compute_dtype
        self._frontend_lock = threading.Lock()
        self._init_dispatch(max_batch, max_wait_ms)

    def _init_dispatch(self, max_batch, max_wait_ms):
        self.batcher = MicroBatcher(self._run_batch, self._bucket_of, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms)

    def _bucket_of(self, req: _ValleCoreRequest):
        return (bucket_ladder(len(req.phone_ids), self.len_step, self.max_phone_len),
                bucket_ladder(req.prompt_codes.shape[1], self.len_step, self.max_prompt_len))

    def synthesize(self, prompt_audio, prompt_text: str, target_text: str,
                   seed: int = 0) -> np.ndarray:
        """Blocking single request; batches with concurrent callers. Returns
        the waveform as float32 numpy."""
        return self.batcher(self._prepare_request(prompt_audio, prompt_text, target_text,
                                                  seed))

    @torch.inference_mode()
    def _prepare_request(self, prompt_audio, prompt_text, target_text,
                         seed) -> _ValleCoreRequest:
        tok = self.tokenizer
        audio = prompt_audio if torch.is_tensor(prompt_audio) else torch.from_numpy(
            np.asarray(prompt_audio, np.float32))
        audio = _pad_audio_grid(audio.to(tok.device, torch.float32), tok.sample_rate,
                                self.audio_grid_s)
        with self._frontend_lock:
            ids = self.g2p.to_ids(prompt_text + " " + target_text, self.symbol_table)
            codes = tok.encode(audio)[0]  # (Q, Lp)
        phone_ids = torch.tensor(ids, dtype=torch.long, device=codes.device)
        return _ValleCoreRequest(phone_ids[: self.max_phone_len],
                                 codes[:, : self.max_prompt_len], seed)

    def stats(self) -> dict:
        return self.batcher.stats.snapshot()

    def shutdown(self) -> None:
        self.batcher.shutdown()

    def _decode(self, codes: torch.Tensor, n_gen: list[int]) -> list[np.ndarray]:
        """Codes (B, Q, T) of ``n_gen`` generated frames each → the
        waveforms, each cut to ``max(n, 1)`` frames."""
        lens = [max(n, 1) for n in n_gen]
        wav = self.tokenizer.decode(codes, torch.tensor(lens)).float().cpu().numpy()
        spf = wav.shape[-1] / codes.shape[-1]
        return [wav[i, : int(round(n * spf))] for i, n in enumerate(lens)]

    @torch.inference_mode()
    def _run_batch(self, bucket, reqs: list[_ValleCoreRequest]) -> list[np.ndarray]:
        lph, lp = bucket
        dev = self.model.device
        phones = torch.stack([_pad_to(r.phone_ids, lph) for r in reqs])
        prompts = torch.stack([_pad_to(r.prompt_codes.T, lp).T for r in reqs])
        codes, gen_len = valle_generate_ragged(
            self.model, phones, torch.tensor([len(r.phone_ids) for r in reqs], device=dev),
            prompts, torch.tensor([r.prompt_codes.shape[1] for r in reqs], device=dev),
            [torch.Generator(dev).manual_seed(r.seed) for r in reqs], max_new=self.max_new,
            temperature=self.temperature, top_k=self.top_k, compute_dtype=self.compute_dtype)
        return self._decode(codes, gen_len.tolist())

    @torch.inference_mode()
    def nar_tail(self, req: _ValleCoreRequest, toks0: torch.Tensor) -> np.ndarray:
        """One request's NAR and codec decode given its AR tokens, at the
        buckets of its phones, its prompt and its ``max(n, 1)`` frames (the
        NAR sees the true count, 0 after an immediate EOS) → its waveform."""
        dev = self.model.device
        n_gen = len(toks0)
        lph = bucket_ladder(len(req.phone_ids), self.len_step, self.max_phone_len)
        lp = bucket_ladder(req.prompt_codes.shape[1], self.len_step, self.max_prompt_len)
        lt = bucket_ladder(max(n_gen, 1), self.len_step, self.max_new)
        codes = nar_generate_ragged(
            self.model, _pad_to(req.phone_ids, lph)[None],
            torch.tensor([len(req.phone_ids)], device=dev),
            _pad_to(toks0.to(dev), lt)[None], torch.tensor([n_gen], device=dev),
            _pad_to(req.prompt_codes.T, lp).T[None],
            torch.tensor([req.prompt_codes.shape[1]], device=dev),
            compute_dtype=self.compute_dtype)
        return self._decode(codes, [n_gen])[0]


@dataclass
class _VevoCoreRequest:
    mode: str  # "timbre" (FM only) | "voice" (AR + FM)
    content: torch.Tensor  # (Lc,) AR content ids (voice; empty otherwise)
    prompt_out: torch.Tensor  # (Lo,) AR output-stream style prompt (voice)
    target_style: torch.Tensor  # (Lt,) source content-style tokens (timbre)
    fm_prompt_tokens: torch.Tensor  # (Lp,) reference content-style tokens
    fm_prompt_mel: torch.Tensor  # (Lp*csf, n_mel) reference clean mel
    seed: int


def voice_generators(seed: int, device) -> tuple[torch.Generator, torch.Generator]:
    """(AR, FM) generators of a voice request with ``seed``."""
    return (torch.Generator(device).manual_seed(2 * seed + 1),
            torch.Generator(device).manual_seed(2 * seed + 2))


class VevoService:
    """Thread-safe batched Vevo synthesis around a `VevoPipeline`; the AR
    and FM run in the pipeline's ``compute_dtype``."""

    def __init__(self, pipeline, max_batch: int = 8, max_wait_ms: float = 50.0,
                 len_step: int = 128, max_content_len: int = 1024,
                 max_prompt_len: int = 512, max_new: int = 1024,
                 flow_matching_steps: int = 32, fm_solver: str = "euler",
                 cfg_scale: float = 0.0, temperature: float = 1.0, top_k: int = 40,
                 audio_grid_s: float = 0.5):
        self.pipe = pipeline
        self.audio_grid_s = audio_grid_s
        self.len_step = len_step
        self.max_content_len = max_content_len
        self.temperature = temperature
        self.top_k = top_k
        self.max_prompt_len = max_prompt_len
        self.max_new = max_new
        self.fm_steps = flow_matching_steps
        self.fm_solver = fm_solver
        self.cfg_scale = cfg_scale
        self._frontend_lock = threading.Lock()
        self._init_dispatch(max_batch, max_wait_ms)

    def _init_dispatch(self, max_batch, max_wait_ms):
        self.batcher = MicroBatcher(self._run_batch, self._bucket_of,
                                    max_batch=max_batch, max_wait_ms=max_wait_ms)

    def _ladder(self, n, cap):
        return bucket_ladder(max(int(n), 1), self.len_step, cap)

    def _bucket_of(self, req: _VevoCoreRequest):
        if req.mode == "voice":
            shape = (self._ladder(len(req.content), self.max_content_len),
                     self._ladder(len(req.prompt_out), self.max_prompt_len))
        else:
            shape = (self._ladder(len(req.target_style), self.max_new),)
        return (req.mode, shape,
                self._ladder(len(req.fm_prompt_tokens), self.max_prompt_len))

    def _fm_prompt(self, ref_style_tokens, ref_audio):
        """(ref content-style tokens, frame-aligned clean mel): the prompt
        protocol of `VevoPipeline.fm_stage`."""
        ptok = ref_style_tokens[: self.max_prompt_len]
        mel = self.pipe._mel(ref_audio)[0]
        csf = self.pipe.fm.cfg.cond_scale_factor
        n_ptok = max(min(len(ptok), mel.shape[0] // csf), 1)
        return ptok[:n_ptok], mel[: n_ptok * csf]

    def synthesize(self, src_audio, ref_audio, mode: str = "timbre",
                   seed: int = 0) -> np.ndarray:
        """Blocking single request; batches with concurrent callers.
        Returns the waveform as float32 numpy."""
        return self.batcher(self._prepare_request(src_audio, ref_audio, mode, seed))

    @torch.inference_mode()
    def _prepare_request(self, src_audio, ref_audio, mode, seed) -> _VevoCoreRequest:
        if mode not in ("timbre", "voice"):
            raise ValueError(f"unknown Vevo mode {mode!r}")
        if mode == "voice" and self.pipe.ar is None:
            raise ValueError("mode='voice' needs a pipeline with an AR stage "
                             "(build_vevo_voice)")
        sr = self.pipe.mel_cfg.sample_rate
        src = _pad_audio_grid(self.pipe.audio(src_audio), sr, self.audio_grid_s)
        ref = _pad_audio_grid(self.pipe.audio(ref_audio), sr, self.audio_grid_s)
        empty = torch.zeros((0,), dtype=torch.long, device=src.device)
        with self._frontend_lock:
            # one style-tokenizer pass over the reference serves the FM
            # prompt and, in voice mode, the AR output-stream prompt
            ref_style = self.pipe.style_tokens(ref)
            ptok, pmel = self._fm_prompt(ref_style, ref)
            if mode == "voice":
                content = self.pipe.content_tokens(torch.cat([ref, src]))
                if len(content) > self.max_content_len:
                    # keep the tail (the source being converted); what
                    # overflows is the reference prefix at the front
                    warnings.warn(
                        f"vevo voice request content ({len(content)} tokens) exceeds "
                        f"max_content_len={self.max_content_len}; truncating the "
                        "reference prefix from the front")
                    content = content[-self.max_content_len:]
                prompt_out, target = ref_style[: self.max_prompt_len], empty
            else:
                content = prompt_out = empty
                target = self.pipe.style_tokens(src)[: self.max_new]
        return _VevoCoreRequest(mode, content, prompt_out, target, ptok, pmel, seed)

    def stats(self) -> dict:
        return self.batcher.stats.snapshot()

    def shutdown(self) -> None:
        self.batcher.shutdown()

    @torch.inference_mode()
    def _run_batch(self, bucket, reqs: list[_VevoCoreRequest]):
        mode, shape, lp_tok = bucket
        pipe = self.pipe
        dev = pipe.device
        if mode == "voice":
            lc, lo = shape
            pad = []
            if (pipe.compute_dtype in ("float32", "bfloat16")
                    or self.batcher.max_batch > GEMV_MAX_M):
                # the decode runs max_batch rows (the first request repeated
                # in the free ones, its rows discarded): every op then sees
                # the same shapes whatever the batch holds, so a request's
                # tokens do not depend on its company (on the card cuBLAS's
                # products change their last bits with the row count).
                # int8/int4 up to GEMV_MAX_M rows need no padding: their
                # step is row-invariant there.
                pad = [reqs[0]] * (self.batcher.max_batch - len(reqs))
            rows = reqs + pad
            toks, gen_len = ar_transformer_generate_ragged(
                pipe.ar, torch.stack([_pad_to(r.content, lc) for r in rows]),
                torch.tensor([len(r.content) for r in rows], device=dev),
                [voice_generators(r.seed, dev)[0] for r in rows], max_new=self.max_new,
                temperature=self.temperature, top_k=self.top_k,
                prompt_output_tokens=torch.stack([_pad_to(r.prompt_out, lo) for r in rows]),
                prompt_output_len=torch.tensor([len(r.prompt_out) for r in rows], device=dev),
                compute_dtype=pipe.compute_dtype)
            toks, gen_len = toks[: len(reqs)], gen_len[: len(reqs)]
            tl = [max(int(n), 1) for n in gen_len.cpu()]
            target = toks[:, :self._ladder(max(tl), self.max_new)]
            fm_gens = [voice_generators(r.seed, dev)[1] for r in reqs]
        else:
            (lt_tok,) = shape
            target = torch.stack([_pad_to(r.target_style, lt_tok) for r in reqs])
            tl = [max(len(r.target_style), 1) for r in reqs]
            fm_gens = [torch.Generator(dev).manual_seed(r.seed) for r in reqs]
        return self._fm_tail(lp_tok, reqs, target, tl, fm_gens)

    @torch.inference_mode()
    def _fm_tail(self, lp_tok: int, reqs: list[_VevoCoreRequest], target: torch.Tensor,
                 tl: list[int], fm_gens: list[torch.Generator]) -> list[np.ndarray]:
        """Flow matching and Vocos for a batch: ``target`` (B, Lt) style
        tokens of ``tl`` valid each, prompted by each request's FM prompt
        (padded to ``lp_tok``) → the waveforms."""
        pipe = self.pipe
        dev = pipe.device
        csf = pipe.fm.cfg.cond_scale_factor
        tlen = torch.tensor(tl, device=dev)
        ptoks = torch.stack([_pad_to(r.fm_prompt_tokens, lp_tok) for r in reqs])
        plen = torch.tensor([len(r.fm_prompt_tokens) for r in reqs], device=dev)
        pmel = torch.stack([_pad_to(r.fm_prompt_mel, lp_tok * csf) for r in reqs])
        mel = fmt_inference_ragged(
            pipe.fm, ptoks, plen, target, tlen, pmel, fm_gens,
            num_steps=self.fm_steps, cfg_scale=self.cfg_scale,
            compute_dtype=pipe.compute_dtype, solver=self.fm_solver)
        wav = pipe.vocoder(mel, tlen * csf).cpu().numpy()
        spf = wav.shape[-1] / mel.shape[1]
        return [wav[i, : int(round(n * csf * spf))] for i, n in enumerate(tl)]
