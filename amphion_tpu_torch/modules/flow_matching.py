"""Conditional flow matching, training side (port of the loss part of
`amphion_tpu/modules/flow_matching.py`): the OT-CFM interpolant
x_t = (1 - (1 - sigma_min) t) x0 + t x1 with x0 = noise, the target velocity
v = x1 - (1 - sigma_min) x0, and the masked squared-error loss."""

from __future__ import annotations

import torch


def cfm_pair(x1: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
             sigma_min: float = 1e-4) -> tuple[torch.Tensor, torch.Tensor]:
    """OT-CFM interpolant → (x_t, target velocity); t (B,) broadcasts over
    x1's trailing dims."""
    tt = t.reshape((-1,) + (1,) * (x1.ndim - 1))
    x_t = (1.0 - (1.0 - sigma_min) * tt) * noise + tt * x1
    return x_t, x1 - (1.0 - sigma_min) * noise


def cfm_loss(v_pred: torch.Tensor, v_target: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean squared error, over the frames where ``mask`` (B, T) is nonzero
    when given. The denominator is JAX's exactly: ``sum(m) · C /
    max(m.shape[-1], 1)`` floored at 1, with m the mask broadcast to
    (B, T, 1), so it counts the masked elements."""
    err = (v_pred - v_target) ** 2
    if mask is None:
        return err.mean()
    m = mask[..., None] if mask.ndim == err.ndim - 1 else mask
    denom = torch.clamp(m.sum() * err.shape[-1] / max(m.shape[-1], 1), min=1.0)
    return (err * m).sum() / denom
