"""The masked cross-entropy that the VALL-E and MaskGCT losses share (JAX
writes it inline in `models/tts/{valle/valle.py,maskgct/maskgct.py}`)."""

from __future__ import annotations

import torch


def masked_nll(logits: torch.Tensor, targets: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """-Σ w·log p(target) / max(Σ w, 1), the log-softmax in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    return -(ll * w).sum() / torch.clamp(w.sum(), min=1.0)
