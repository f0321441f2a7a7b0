"""Ragged-batch packing for serving (port of `amphion_tpu/ops/ragged.py`).

B requests with different lengths share one padded buffer: each sample's
segments are packed left-aligned ``[seg0_i | seg1_i | ... | pad]`` so its
rotary positions are those of a solo run, and pad positions are masked.
"""

from __future__ import annotations

import torch


def _expand(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B, L) indices → broadcast over like's trailing dims for gather."""
    return idx.view(*idx.shape, *([1] * (like.ndim - 2))).expand(
        *idx.shape, *like.shape[2:])


def pack_segments(segments: list[torch.Tensor],
                  lengths: list[torch.Tensor]) -> torch.Tensor:
    """Left-aligned per-sample concatenation of right-padded segments.

    segments[k] (B, Lk_max, ...) right-padded; lengths[k] (B,). Returns
    (B, sum Lk_max, ...) laid out ``[seg0_i[:l0_i] | seg1_i[:l1_i] | ... | pad]``.
    """
    total = sum(s.shape[1] for s in segments)
    b = segments[0].shape[0]
    pos = torch.arange(total, device=segments[0].device)[None, :]
    out = None
    offset = torch.zeros((b, 1), dtype=torch.long, device=pos.device)
    for seg, ln in zip(segments, lengths):
        idx = torch.clamp(pos - offset, 0, seg.shape[1] - 1)
        gathered = torch.gather(seg, 1, _expand(idx, seg))
        if out is None:
            out = gathered
        else:
            keep = (pos >= offset).view(b, total, *([1] * (seg.ndim - 2)))
            out = torch.where(keep, gathered, out)
        offset = offset + ln.to(pos.device, torch.long)[:, None]
    return out


def unpack_target(full: torch.Tensor, prefix_len: torch.Tensor,
                  t_max: int) -> torch.Tensor:
    """Gather ``full[i, prefix_len_i : prefix_len_i + t_max]`` per sample."""
    pos = torch.arange(t_max, device=full.device)[None, :]
    idx = torch.clamp(prefix_len.to(full.device, torch.long)[:, None] + pos,
                      0, full.shape[1] - 1)
    return torch.gather(full, 1, _expand(idx, full))


def masked_std(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-sample std over valid (B, T) positions of x (B, T, D) → (B, 1, 1)
    (population std, as ``jnp.std``)."""
    w = valid.to(torch.float32)[..., None]
    xf = x.float()
    n = torch.clamp(w.sum(dim=(1, 2)) * x.shape[-1], min=1.0)
    mean = (xf * w).sum(dim=(1, 2)) / n
    var = (torch.square(xf - mean[:, None, None]) * w).sum(dim=(1, 2)) / n
    return torch.sqrt(var)[:, None, None]


def pack_segments_right(segments: list[torch.Tensor],
                        lengths: list[torch.Tensor]) -> torch.Tensor:
    """Right-aligned per-sample concatenation ``[pad | seg0_i | seg1_i | ...]``,
    every sample ending at the buffer's last position, so an AR decode loop
    appends at one shared ``cache_index`` (exact under rotary positions:
    scores depend only on relative distance). The pad prefix holds clamped
    segment-0 content: mask it with `right_pack_valid`."""
    total = sum(s.shape[1] for s in segments)
    dev = segments[0].device
    lengths = [ln.to(dev, torch.long) for ln in lengths]
    start = total - sum(lengths)  # (B,) left pad per sample
    pos = torch.arange(total, device=dev)[None, :]
    out = None
    offset = start[:, None]
    for seg, ln in zip(segments, lengths):
        idx = torch.clamp(pos - offset, 0, seg.shape[1] - 1)
        gathered = torch.gather(seg, 1, _expand(idx, seg))
        if out is None:
            out = gathered
        else:
            keep = (pos >= offset).view(-1, total, *([1] * (seg.ndim - 2)))
            out = torch.where(keep, gathered, out)
        offset = offset + ln[:, None]
    return out


def right_pack_valid(lengths: list[torch.Tensor], total: int,
                     n_slots: int) -> torch.Tensor:
    """(B, n_slots) bool: slot s holds real content under the right-aligned
    layout of ``total`` packed positions (slots ≥ total, the decode
    appends, are always valid)."""
    start = total - sum(ln.to(torch.long) for ln in lengths)
    return torch.arange(n_slots, device=start.device)[None, :] >= start[:, None]
