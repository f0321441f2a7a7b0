"""Batched Vevo serving (port of `VevoService`,
`amphion_tpu/serving/service.py:328-510`, the window batcher).

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
``2 * seed + 1`` and the FM noise from ``2 * seed + 2``), and the voice
decode always runs ``max_batch`` rows, so a request's tokens do not depend
on the batch it lands in (its waveform only within the flow matching's
float tolerance).
"""

from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from amphion_tpu_torch.models.vc.ar_transformer import ar_transformer_generate_ragged
from amphion_tpu_torch.models.vc.flow_matching_transformer import fmt_inference_ragged
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
        csf = pipe.fm.cfg.cond_scale_factor
        if mode == "voice":
            lc, lo = shape
            gens = [voice_generators(r.seed, dev) for r in reqs]
            # the decode always runs max_batch rows (the first request
            # repeated in the free ones, its rows discarded): every op then
            # sees the same shapes whatever the batch holds, so a request's
            # tokens do not depend on its company (on the card the bf16
            # lm_head product and the RMSNorm mean change their last bits
            # with the row count)
            pad = [reqs[0]] * (self.batcher.max_batch - len(reqs))
            rows = reqs + pad
            ar_gens = [g[0] for g in gens] + [voice_generators(r.seed, dev)[0] for r in pad]
            toks, gen_len = ar_transformer_generate_ragged(
                pipe.ar, torch.stack([_pad_to(r.content, lc) for r in rows]),
                torch.tensor([len(r.content) for r in rows], device=dev),
                ar_gens, max_new=self.max_new,
                temperature=self.temperature, top_k=self.top_k,
                prompt_output_tokens=torch.stack([_pad_to(r.prompt_out, lo) for r in rows]),
                prompt_output_len=torch.tensor([len(r.prompt_out) for r in rows], device=dev),
                compute_dtype=pipe.compute_dtype)
            toks, gen_len = toks[: len(reqs)], gen_len[: len(reqs)]
            tl = [max(int(n), 1) for n in gen_len.cpu()]
            lt_tok = self._ladder(max(tl), self.max_new)
            target = toks[:, :lt_tok]
            fm_gens = [g[1] for g in gens]
        else:
            (lt_tok,) = shape
            target = torch.stack([_pad_to(r.target_style, lt_tok) for r in reqs])
            tl = [max(len(r.target_style), 1) for r in reqs]
            fm_gens = [torch.Generator(dev).manual_seed(r.seed) for r in reqs]
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
