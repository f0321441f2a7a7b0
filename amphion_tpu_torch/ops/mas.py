"""Monotonic Alignment Search (port of `amphion_tpu/ops/mas.py`): VITS's
Viterbi max-path through the (text × mel) log-likelihood lattice, batched,
on the lattice's own device.

Two loops over mel frames, as JAX's two ``lax.scan`` passes: the forward
DP keeps one (B, T_text) column, ``q_t[j] = value[j, t] + max(q_{t−1}[j],
q_{t−1}[j−1])``, and records where staying on ``j`` was at least as good
as advancing (``stay = q >= q_prev``, JAX's tie rule); the backtrack walks
from ``(text_len − 1, mel_len − 1)`` to frame 0 through those choices. The
additions and maxima are the same float32 operations in the same order as
JAX's, so the path is exact, not approximate. JAX writes no Pallas kernel
here and neither does the port: each frame is a few small tensor
operations on the device (no host round trip), under ``no_grad`` as JAX
runs it under ``stop_gradient``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_NEG = -1e9


@torch.no_grad()
def maximum_path(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Monotonic max-path through a similarity lattice.

    value: (B, T_text, T_mel) log-likelihood lattice; mask: (B, T_text,
    T_mel) valid region (the outer product of the text and mel masks).
    Returns the one-hot alignment (B, T_text, T_mel) in ``value``'s dtype,
    zero in the padding."""
    b, t_text, t_mel = value.shape
    valid = mask > 0
    value = torch.where(valid, value, torch.full((), _NEG, dtype=value.dtype,
                                                 device=value.device))
    text_len = valid[:, :, 0].sum(dim=1).clamp(min=1)
    mel_len = valid[:, 0, :].sum(dim=1).clamp(min=1)
    cols = value.permute(2, 0, 1).contiguous()  # (T_mel, B, T_text)

    # forward DP over frames 1 .. T_mel − 1
    text_idx = torch.arange(t_text, device=value.device)
    q = torch.where(text_idx[None, :] == 0, cols[0], torch.full_like(cols[0], _NEG))
    stay = torch.empty((max(t_mel - 1, 0), b, t_text), dtype=torch.bool, device=value.device)
    for t in range(1, t_mel):
        q_prev = F.pad(q[:, :-1], (1, 0), value=_NEG)
        torch.ge(q, q_prev, out=stay[t - 1])
        q = torch.maximum(q, q_prev).add_(cols[t])

    # backtrack from (text_len − 1, mel_len − 1)
    j = text_len - 1
    j_path = torch.empty((t_mel, b), dtype=torch.int64, device=value.device)
    last = mel_len - 1
    for t in range(t_mel - 1, 0, -1):
        inside = t <= last
        stay_here = torch.gather(stay[t - 1], 1, j[:, None])[:, 0]
        j_path[t] = torch.where(inside, j, -1)
        j = torch.where(inside & ~stay_here, (j - 1).clamp(min=0), j)
    j_path[0] = j
    path = (text_idx[None, :, None] == j_path.T[:, None, :]).to(value.dtype)
    return path * valid
