"""Audio tokenizer facade (port of `amphion_tpu/utils/tokenizer.py`): encode
and decode through the port's `AmphionCodec`, the token space VALL-E is
served with. Both run the codec's Snake activations (kernel 1) on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec


@dataclass
class AudioTokenizer:
    codec: AmphionCodec
    sample_rate: int = 24000

    @property
    def device(self) -> torch.device:
        return next(self.codec.parameters()).device

    @property
    def hop(self) -> int:
        return self.codec.cfg.hop

    def encode(self, audio) -> torch.Tensor:
        """(T,) or (B, T) waveform, numpy or tensor → (B, Q, N) int64 codes
        on the codec's device."""
        x = torch.as_tensor(np.asarray(audio, np.float32) if not torch.is_tensor(audio)
                            else audio).to(self.device, torch.float32)
        if x.ndim == 1:
            x = x[None]
        return self.codec.encode(x).transpose(0, 1)

    def decode(self, codes: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        """(B, Q, N) codes → (B, N·hop) float32 waveform. With ``lengths``
        (B,), each row's valid frame count, the decode is length-masked: row
        ``i``'s first ``lengths[i]·hop`` samples equal its decode alone."""
        codes = codes.to(self.device)
        if lengths is not None:
            lengths = torch.as_tensor(lengths).to(self.device)
        return self.codec.decode_codes(codes.transpose(0, 1), lengths)
