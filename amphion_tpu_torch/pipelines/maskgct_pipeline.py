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
components through the ragged samplers; the single-request ``__call__`` of
the JAX pipeline and its fixed-shape samplers are not ported. Modules live
on the pipeline's device; T2S and S2A are cast to ``compute_dtype`` once,
when the pipeline is built, the codecs stay float32.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

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
from amphion_tpu_torch.models.tts.maskgct.ragged_sampling import DTYPES
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
