"""MaskGCT zero-shot TTS pipeline, its components (port of
`amphion_tpu/pipelines/maskgct_pipeline.py`): text + a prompt recording →
24 kHz speech through

    prompt audio → semantic extractor (the served path: log-mel, kernel 3)
                 → RepCodec semantic tokens
    prompt audio → Amphion codec encoder (Snake: kernel 1) → RVQ codes
    phones + semantic prompt → T2S mask-predict (kernel 6 in every layer)
    semantic tokens + acoustic prompt → S2A mask-predict, layer by layer
    → codec decode (kernel 1)

The batched serving path (`serving/service.MaskGCTService`) drives these
components through the ragged samplers; ``__call__`` (the TTS CLI's
MaskGCT mode) runs one request through the same samplers as a batch of one.
Modules live on the pipeline's device; T2S and S2A are cast to
``compute_dtype`` once, when the pipeline is built, the codecs stay
float32.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator

import numpy as np
import torch

from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec, CodecConfig
from amphion_tpu_torch.models.codec.repcodec import RepCodec, RepCodecConfig
from amphion_tpu_torch.models.tts.maskgct.maskgct import (
    MaskGCTS2A,
    MaskGCTT2S,
    S2AConfig,
    T2SConfig,
    s2a_conditioning,
)
from amphion_tpu_torch.models.tts.maskgct.ragged_sampling import (
    DTYPES,
    maskgct_generators,
    s2a_sample_ragged,
    t2s_sample_ragged,
)
from amphion_tpu_torch.modules.llama import cast_params
from amphion_tpu_torch.text.g2p import G2PModule
from amphion_tpu_torch.text.symbol_table import SymbolTable


@dataclass
class MaskGCTPipeline:
    t2s: MaskGCTT2S
    s2a: MaskGCTS2A
    semantic_codec: RepCodec
    acoustic_codec: AmphionCodec
    semantic_extractor: Callable  # audio (T,) tensor → (T', D) features
    g2p: G2PModule = field(default_factory=lambda: G2PModule("char"))
    symbol_table: SymbolTable | None = None
    sample_rate: int = 24000
    semantic_rate: int = 50  # Hz
    compute_dtype: str = "bfloat16"

    @classmethod
    def build(cls, t2s_cfg: T2SConfig, s2a_cfg: S2AConfig, sem_cfg: RepCodecConfig,
              ac_cfg: CodecConfig, states: dict, device, compute_dtype: str = "bfloat16",
              **kw) -> "MaskGCTPipeline":
        """Modules from their state dicts (``states["t2s"]``, ``"s2a"``,
        ``"semantic_codec"``, ``"acoustic_codec"``) on ``device``. The S2A
        holds ``cond_emb`` and ``sem_proj`` as its state does."""
        if compute_dtype not in DTYPES:
            raise ValueError(f"MaskGCT serves float32 or bfloat16, not {compute_dtype!r}")
        token_cond, feature_cond = s2a_conditioning(states["s2a"])
        mods = {"t2s": MaskGCTT2S(t2s_cfg),
                "s2a": MaskGCTS2A(s2a_cfg, token_cond, feature_cond),
                "semantic_codec": RepCodec(sem_cfg, with_decode=True),
                "acoustic_codec": AmphionCodec(ac_cfg)}
        for name, mod in mods.items():
            mod.load_state_dict(states[name])
            mod.to(device).eval().requires_grad_(False)
        for name in ("t2s", "s2a"):
            cast_params(mods[name], DTYPES[compute_dtype])
        return cls(**mods, compute_dtype=compute_dtype, **kw)

    @property
    def device(self) -> torch.device:
        return self.t2s.mask_emb.device

    @property
    def token_cond(self) -> bool:
        """Whether the S2A conditions on semantic tokens (its checkpoint holds
        ``cond_emb``) or on the semantic codec's decoded latents."""
        return self.s2a.token_cond

    def audio(self, audio) -> torch.Tensor:
        """A waveform as a float32 tensor on the pipeline's device."""
        if not torch.is_tensor(audio):
            audio = torch.from_numpy(np.asarray(audio, np.float32))
        return audio.to(self.device, torch.float32)

    # -- components ---------------------------------------------------------------

    def extract_semantic_code(self, audio) -> torch.Tensor:
        """Semantic tokens (1, T') of a waveform."""
        feats = self.semantic_extractor(self.audio(audio))
        return self.semantic_codec.encode(feats[None])

    def extract_acoustic_code(self, audio) -> torch.Tensor:
        """Acoustic codes (Q, 1, N) of a waveform."""
        return self.acoustic_codec.encode(self.audio(audio)[None])

    def codec_decode(self, codes: torch.Tensor,
                     frame_lengths: torch.Tensor | None = None) -> torch.Tensor:
        """codes (B, Q, N) → waveforms (B, N·hop), length-masked per row with
        ``frame_lengths``."""
        return self.acoustic_codec.decode_codes(codes.transpose(0, 1), frame_lengths)

    def text2semantic(self, prompt_semantic, phone_ids, target_len: int, generator=None,
                      n_steps: int = 25, cfg: float = 2.5,
                      gumbel: Iterator | None = None) -> torch.Tensor:
        """Semantic tokens (1, target_len) after ``prompt_semantic`` (1, Lp)
        for ``phone_ids`` (a list), by `t2s_sample_ragged` on a batch of one
        (CFG 2.5, as JAX's pipeline runs it)."""
        phones = torch.tensor(phone_ids, dtype=torch.long, device=self.device)[None]
        def n(length: int) -> torch.Tensor:  # a length of the batch of one
            return torch.tensor([length], device=self.device)
        return t2s_sample_ragged(self.t2s, prompt_semantic, n(prompt_semantic.shape[1]),
                                 phones, n(len(phone_ids)), n(target_len), [generator],
                                 target_len, n_steps=n_steps, cfg=cfg,
                                 compute_dtype=self.compute_dtype, gumbel=gumbel)

    def semantic2acoustic(self, semantic_tokens, prompt_acoustic, generator=None,
                          prompt_semantic=None, first_layer_steps: int = 16,
                          gumbel: Iterator | None = None) -> torch.Tensor:
        """Acoustic codes (B, Q, T) of the generated semantic tokens (B, T)
        after the acoustic prompt (B, Q, Lp), by `s2a_sample_ragged` with
        every row at full length and ``generator`` drawing for each. The S2A
        conditions as its checkpoint was trained: on the token stream
        ``prompt_semantic[:, :Lp] ++ semantic_tokens`` where it holds
        ``cond_emb``, else on the semantic codec's decoded latents of it
        (without ``prompt_semantic``: of the target alone, zeros over the
        prompt)."""
        lp = prompt_acoustic.shape[2]
        tok_full = (semantic_tokens if prompt_semantic is None
                    else torch.cat([prompt_semantic[:, :lp], semantic_tokens], dim=1))
        if prompt_semantic is not None and self.token_cond:
            sem_full = tok_full
        else:
            sem_full = self.semantic_codec.decode_tokens(tok_full)
            if prompt_semantic is None:
                pad = sem_full.new_zeros((sem_full.shape[0], lp, sem_full.shape[2]))
                sem_full = torch.cat([pad, sem_full], dim=1)
        b, t_len = semantic_tokens.shape
        return s2a_sample_ragged(self.s2a, sem_full, prompt_acoustic, torch.full((b,), lp, device=self.device),
                                 torch.full((b,), t_len, device=self.device), [generator] * b, t_len,
                                 first_layer_steps=first_layer_steps,
                                 compute_dtype=self.compute_dtype, gumbel=gumbel)

    @torch.inference_mode()
    def __call__(self, prompt_audio, prompt_text: str, target_text: str, seed: int = 0,
                 target_len: int | None = None,
                 gumbel: tuple[Iterator, Iterator] | None = None) -> np.ndarray:
        """One zero-shot request → its waveform (float32 numpy). Without
        ``target_len`` the target runs ``int(Lp_semantic · phones_target /
        phones_prompt) + 1`` semantic frames. The T2S and S2A draw from the
        generators of ``seed`` (`maskgct_generators`, as the service draws),
        or from ``gumbel``: (T2S draws, S2A draws)."""
        if self.symbol_table is None:
            self.symbol_table = self.g2p.build_symbol_table([prompt_text, target_text])
        phones_prompt = self.g2p.to_ids(prompt_text, self.symbol_table)
        phones_target = self.g2p.to_ids(target_text, self.symbol_table)
        prompt_semantic = self.extract_semantic_code(prompt_audio)  # (1, Lp')
        prompt_acoustic = self.extract_acoustic_code(prompt_audio).transpose(0, 1)  # (1, Q, Lp)
        if target_len is None:
            ratio = max(len(phones_target), 1) / max(len(phones_prompt), 1)
            target_len = int(prompt_semantic.shape[1] * ratio) + 1
        g_t2s, g_s2a = maskgct_generators(seed, self.device)
        d_t2s, d_s2a = gumbel if gumbel is not None else (None, None)
        semantic = self.text2semantic(prompt_semantic, phones_prompt + phones_target,
                                      target_len, g_t2s, gumbel=d_t2s)
        codes = self.semantic2acoustic(semantic, prompt_acoustic, g_s2a,
                                       prompt_semantic=prompt_semantic, gumbel=d_s2a)
        return self.codec_decode(codes)[0].float().cpu().numpy()
