"""Vevo inference pipeline (port of `amphion_tpu/pipelines/vevo_pipeline.py`,
the Vevo-Timbre and Vevo-Voice products).

Vevo-Timbre re-renders the source's content-style tokens with the reference
speaker's timbre:

    audio → log-mel (kernel 3) → RepCodec style tokens
    [ref tokens | src tokens] + ref mel → flow matching (kernel 6 in every
    attention layer, every ODE step) → mel → Vocos → waveform

Vevo-Voice first rewrites the content into the style reference's style:

    [style ref ‖ src] → RepCodec content tokens (vocab 32, duration-reduced)
    → AR decode prompted with the style reference's own content-style tokens
    (kernels 4/5 in every projection, kernel 8 in single-step attention when
    ``AMPHION_FUSED_DECODE_ATTN`` is set) → flow matching → Vocos

With ``compute_dtype`` int8 or int4 the AR decoder and the flow-matching
estimator are quantized once, by the builder (`build_vevo_voice`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from amphion_tpu_torch.models.codec.repcodec import RepCodec, RepCodecConfig
from amphion_tpu_torch.models.vc.ar_transformer import (
    ARTransformer,
    ARTransformerConfig,
    ar_transformer_generate,
    prepare_for_decode,
)
from amphion_tpu_torch.models.vc.flow_matching_transformer import (
    FlowMatchingTransformer,
    FMTConfig,
    fmt_inference,
    prepare_for_inference,
)
from amphion_tpu_torch.models.vocoders.vocos import VocosConfig, VocosGenerator
from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram
from amphion_tpu_torch.utils.device import resolve_device


def duration_reduce(tokens: torch.Tensor) -> torch.Tensor:
    """Collapse consecutive duplicate tokens."""
    if tokens.numel() == 0:
        return tokens
    return torch.unique_consecutive(tokens)


@dataclass
class VevoPipeline:
    style_tokenizer: RepCodec  # vocab 8192
    fm: FlowMatchingTransformer  # prepared for compute_dtype
    vocoder: VocosGenerator
    ssl_extractor: Callable[[torch.Tensor], torch.Tensor]  # audio (T,) → (T', D)
    mel_cfg: MelConfig = MelConfig()
    compute_dtype: str = "bfloat16"
    content_tokenizer: RepCodec | None = None  # vocab 32 (Vevo-Voice)
    ar: ARTransformer | None = None  # prepared for compute_dtype (Vevo-Voice)

    @property
    def device(self) -> torch.device:
        return next(self.fm.parameters()).device

    def audio(self, audio) -> torch.Tensor:
        """A waveform as a float32 tensor on the pipeline's device."""
        if not torch.is_tensor(audio):
            audio = torch.from_numpy(np.asarray(audio, np.float32))
        return audio.to(self.device, torch.float32)

    # -- tokenization --------------------------------------------------------

    def style_tokens(self, audio) -> torch.Tensor:
        """Content-style tokens (T',) int64 of a waveform."""
        feats = self.ssl_extractor(self.audio(audio))[None]
        return self.style_tokenizer.encode(feats)[0]

    def content_tokens(self, audio, reduce: bool = True) -> torch.Tensor:
        """Content tokens (T',) int64 of a waveform, duration-reduced."""
        if self.content_tokenizer is None:
            raise ValueError("this pipeline has no content tokenizer (a Vevo-Timbre "
                             "pipeline): build it with build_vevo_voice")
        feats = self.ssl_extractor(self.audio(audio))[None]
        toks = self.content_tokenizer.encode(feats)[0]
        return duration_reduce(toks) if reduce else toks

    def _mel(self, audio) -> torch.Tensor:
        """(1, T, n_mel) mel of a waveform, hop-truncated."""
        audio = self.audio(audio)
        hop = self.mel_cfg.hop_size
        t = max(len(audio) // hop * hop, hop)
        return mel_spectrogram(audio[:t][None], self.mel_cfg).transpose(1, 2)

    # -- stages ----------------------------------------------------------------

    def ar_stage(self, input_tokens: torch.Tensor,
                 generator: torch.Generator | None = None, max_new: int = 2048,
                 speculative: int = 0, prompt_output_tokens=None,
                 temperature: float = 1.0, top_k: int = 40, top_p: float = 1.0):
        """AR content → content-style decode of one utterance; the generated
        tokens up to (not including) EOS."""
        if speculative > 0:
            raise NotImplementedError("speculative decode is not ported")
        if self.ar is None:
            raise ValueError("this pipeline has no AR stage: build it with build_vevo_voice")
        tokens, lengths = ar_transformer_generate(
            self.ar, input_tokens.to(self.device)[None], generator, max_new=max_new,
            temperature=temperature, top_k=top_k, top_p=top_p,
            prompt_output_tokens=prompt_output_tokens,
            compute_dtype=self.compute_dtype)
        return tokens[0, : int(lengths[0])]

    def fm_stage(self, style_tokens: torch.Tensor, prompt_audio,
                 generator: torch.Generator | None = None,
                 flow_matching_steps: int = 32,
                 prompt_tokens: torch.Tensor | None = None,
                 solver: str = "euler", noise: torch.Tensor | None = None):
        """Target mel (1, Lt, n_mel) for ``style_tokens`` with the timbre of
        ``prompt_audio`` (its own tokens and clean mel are the prefix)."""
        prompt_mel = self._mel(prompt_audio)
        csf = self.fm.cfg.cond_scale_factor
        if prompt_tokens is None:
            prompt_tokens = self.style_tokens(prompt_audio)
        n_ptok = min(len(prompt_tokens), prompt_mel.shape[1] // csf)
        tok = torch.cat([prompt_tokens[:n_ptok].to(self.device),
                         style_tokens.to(self.device)])[None]
        return fmt_inference(
            self.fm, tok, prompt_mel[:, : n_ptok * csf], generator,
            num_steps=flow_matching_steps, compute_dtype=self.compute_dtype,
            noise=noise, solver=solver)

    @torch.inference_mode()
    def vocode(self, mel: torch.Tensor) -> torch.Tensor:
        return self.vocoder(mel.float())[0]

    # -- products ------------------------------------------------------------

    def inference_fm(self, src_audio, ref_audio,
                     generator: torch.Generator | None = None, **kw):
        """Vevo-Timbre: keep the source's style tokens, use the ref's timbre."""
        style = self.style_tokens(src_audio)
        return self.vocode(self.fm_stage(style, ref_audio, generator, **kw))

    def ar_style_prompt(self, style_ref_audio) -> torch.Tensor:
        """(1, Lo) prompt for the AR output stream: the style reference's own
        content-style tokens (the AR has no global timbre encoder)."""
        return self.style_tokens(style_ref_audio)[None]

    def inference_ar_and_fm(self, src_audio, style_ref_audio, timbre_ref_audio,
                            generator: torch.Generator | None = None,
                            fm_generator: torch.Generator | None = None,
                            use_style_prompt: bool = True, max_new: int = 2048,
                            temperature: float = 1.0, top_k: int = 40,
                            top_p: float = 1.0, **kw):
        """Vevo-Voice: content of src → style of style-ref → timbre of
        timbre-ref. With ``use_style_prompt`` the content tokens come from
        [style_ref ‖ src] and the output stream is prompted with the style
        reference's content-style tokens. ``generator`` draws the AR's tokens,
        ``fm_generator`` the flow-matching noise (``noise=`` replaces it)."""
        if use_style_prompt:
            content = self.content_tokens(torch.cat([self.audio(style_ref_audio),
                                                     self.audio(src_audio)]))
            prompt_out = self.ar_style_prompt(style_ref_audio)
        else:
            content = self.content_tokens(src_audio)
            prompt_out = None
        style = self.ar_stage(content, generator, max_new=max_new,
                              prompt_output_tokens=prompt_out,
                              temperature=temperature, top_k=top_k, top_p=top_p)
        mel = self.fm_stage(style, timbre_ref_audio, fm_generator, **kw)
        return self.vocode(mel)


def _tokenizer(cfg: dict, name: str, vocab: int) -> RepCodec:
    m = cfg.get("model", {}).get(name, {})
    return RepCodec(RepCodecConfig(
        feature_dim=cfg["preprocess"]["n_mel"], hidden=m.get("hidden", 128),
        codebook_size=vocab, codebook_dim=m.get("codebook_dim", 8),
        num_blocks=m.get("num_blocks", 2)))


def vevo_modules(cfg: dict, voice: bool) -> dict:
    """The Vevo modules of a config, with torch's default initialisation:
    ``style_tokenizer``, ``fm``, ``vocoder`` and, with ``voice``,
    ``content_tokenizer`` and ``ar`` (FFN 4096 unless ``model.ar`` names
    ``intermediate``)."""
    p, model = cfg["preprocess"], cfg.get("model", {})
    fm_m, ar_m = model.get("fm", {}), model.get("ar", {})
    voc_m = model.get("vocos", {})
    in_vocab = ar_m.get("input_vocab", 32)
    vocab = fm_m.get("token_vocab", ar_m.get("output_vocab", 8192))
    mods = {
        "style_tokenizer": _tokenizer(cfg, "style_tokenizer", vocab),
        "fm": FlowMatchingTransformer(FMTConfig(
            token_vocab=vocab, n_mel=p["n_mel"], hidden=fm_m.get("hidden", 1024),
            num_layers=fm_m.get("num_layers", 16), num_heads=fm_m.get("num_heads", 16))),
        "vocoder": VocosGenerator(VocosConfig(
            n_mel=p["n_mel"], dim=voc_m.get("dim", 512),
            intermediate_dim=voc_m.get("intermediate_dim", 1536),
            num_layers=voc_m.get("num_layers", 8), n_fft=p["n_fft"], hop_size=p["hop_size"])),
    }
    if voice:
        mods["content_tokenizer"] = _tokenizer(cfg, "content_tokenizer", in_vocab)
        mods["ar"] = ARTransformer(ARTransformerConfig(
            input_vocab=in_vocab, output_vocab=vocab,
            hidden=ar_m.get("hidden", 1024), num_layers=ar_m.get("num_layers", 16),
            num_heads=ar_m.get("num_heads", 16), intermediate=ar_m.get("intermediate", 4096)))
    return mods


def assemble_pipeline(cfg: dict, mods: dict, device, compute_dtype: str) -> VevoPipeline:
    """A `VevoPipeline` of `vevo_modules`' modules holding their final
    weights: each moved to ``device`` in eval mode, the FM and the AR
    prepared once for ``compute_dtype``, the mel front end as the SSL
    features (no HuBERT)."""
    mel_cfg = MelConfig.from_preprocess_cfg(cfg["preprocess"])

    def ssl(audio: torch.Tensor) -> torch.Tensor:
        t = len(audio) // mel_cfg.hop_size * mel_cfg.hop_size
        return mel_spectrogram(audio[:t][None], mel_cfg)[0].T

    def on(name):
        m = mods.get(name)
        return None if m is None else m.to(device).eval()

    ar = on("ar")
    return VevoPipeline(
        style_tokenizer=on("style_tokenizer"),
        fm=prepare_for_inference(on("fm"), compute_dtype),
        vocoder=on("vocoder"), ssl_extractor=ssl, mel_cfg=mel_cfg,
        compute_dtype=compute_dtype, content_tokenizer=on("content_tokenizer"),
        ar=None if ar is None else prepare_for_decode(ar, compute_dtype))


def _build(cfg: dict, seed: int, device, compute_dtype: str, voice: bool) -> VevoPipeline:
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        mods = vevo_modules(cfg, voice)
    return assemble_pipeline(cfg, mods, device, compute_dtype)


def build_vevo_timbre(cfg: dict, seed: int = 0, device=None,
                      compute_dtype: str = "bfloat16") -> VevoPipeline:
    """The Vevo-Timbre pipeline of a Vevo config with random weights from
    ``seed`` (no checkpoint is loaded), as `bins/vc/inference.py` assembles
    it: a RepCodec style tokenizer over the mel front end (no HuBERT), the
    flow-matching transformer prepared once for ``compute_dtype``, and
    Vocos. Runs on ``cuda`` unless ``device`` names another device."""
    return _build(cfg, seed, device, compute_dtype, voice=False)


def build_vevo_voice(cfg: dict, seed: int = 0, device=None,
                     compute_dtype: str = "bfloat16") -> VevoPipeline:
    """`build_vevo_timbre` plus the Vevo-Voice stage: a RepCodec content
    tokenizer (vocab ``ar.input_vocab``, 32) and the AR transformer
    (``model.ar`` of the config; FFN 4096 unless it names ``intermediate``).
    With ``compute_dtype`` int8 or int4 the AR decoder's and the
    flow-matching estimator's projections are quantized here, once."""
    return _build(cfg, seed, device, compute_dtype, voice=True)
