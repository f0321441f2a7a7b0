"""Frame energy from a log-mel (port of `energy_from_log_mel` of
`amphion_tpu/ops/energy.py`, the mode the acoustic features use; the
waveform mode is not ported, ROADMAP A6.7). Plain tensor arithmetic on
either device: JAX computes it with XLA, no Pallas kernel."""

from __future__ import annotations

import torch


def energy_from_log_mel(log_mel: torch.Tensor) -> torch.Tensor:
    """'from_mel' mode: sqrt(sum(exp(mel)^2)) over mel bins.
    (B, n_mel, N) log-mel → (B, N)."""
    return torch.sqrt(torch.sum(torch.exp(log_mel) ** 2, dim=-2))
