"""YIN F0 tracking on tensors (port of `F0Config` and `yin_f0` of
`amphion_tpu/ops/f0.py`; its pYIN tracker and F0 utilities are not ported).

The YIN algorithm (de Cheveigné & Kawahara 2002) batched over frames: the
difference function from an FFT autocorrelation and cumulative energies,
the cumulative-mean-normalised difference (CMND), the first dip under the
threshold followed to its local minimum (else the global minimum, then
unvoiced), and a parabolic refinement. Frames are aligned with the mel
front end: ``(frame_length − hop)/2`` reflect padding gives exactly
``T // hop_size`` frames. On the card the FFTs are cuFFT's, as JAX's are
XLA's: no Pallas kernel computes F0.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from amphion_tpu_torch.ops.stft import frame_signal


@dataclass(frozen=True)
class F0Config:
    sample_rate: int = 24000
    hop_size: int = 120
    f0_min: float = 50.0
    f0_max: float = 1100.0
    frame_length: int = 1024
    threshold: float = 0.15  # CMND voicing threshold

    @classmethod
    def from_preprocess_cfg(cls, p: dict) -> "F0Config":
        return cls(sample_rate=p["sample_rate"], hop_size=p["hop_size"],
                   f0_min=float(p.get("f0_min", 50)), f0_max=float(p.get("f0_max", 1100)))


def _cmnd_frames(y: torch.Tensor, cfg: F0Config):
    """The CMND of each frame of a batch of waveforms → (cmnd (B, N, W/2+1),
    tau_min, tau_max, band mask (W/2+1,))."""
    if y.ndim == 1:
        y = y[None]
    y = y.float()
    w, hop = cfg.frame_length, cfg.hop_size
    pad = (w - hop) // 2
    ypad = F.pad(y[:, None], (pad, w - hop - pad), mode="reflect")[:, 0]
    frames = frame_signal(ypad, w, hop)  # (B, N, W)

    tau_min = max(2, int(cfg.sample_rate / cfg.f0_max))
    tau_max = min(w // 2, int(cfg.sample_rate / cfg.f0_min) + 1)

    # d(tau) = sum_{n<W-tau} (x_n - x_{n+tau})^2 from the linear
    # autocorrelation (zero-padded FFT) and cumulative energies
    nfft = 2 * w
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)
    acf = torch.fft.irfft(spec * spec.conj(), n=nfft, dim=-1)[..., : w // 2 + 1]
    sq = frames * frames
    csum = torch.cat([torch.zeros_like(sq[..., :1]), torch.cumsum(sq, dim=-1)], dim=-1)
    tau = torch.arange(w // 2 + 1, device=y.device)
    total = csum[..., w: w + 1]
    d = csum[..., w - tau] + (total - csum[..., tau]) - 2.0 * acf

    # CMND: d'(tau) = d(tau) · tau / cumsum(d)(tau), d'(0) = 1
    dcum = torch.cumsum(d[..., 1:], dim=-1)
    cmnd = d[..., 1:] * tau[1:] / torch.clamp(dcum, min=1e-8)
    cmnd = torch.cat([torch.ones_like(d[..., :1]), cmnd], dim=-1)
    # digital silence makes the CMND 0/0: an energy floor keeps it unvoiced
    energy = total[..., 0] / w
    cmnd = torch.where((energy < 1e-9)[..., None], torch.ones_like(cmnd), cmnd)
    band = (tau >= tau_min) & (tau <= tau_max)
    return cmnd, tau_min, tau_max, band


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 where none is)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def yin_f0(y: torch.Tensor, cfg: F0Config) -> tuple[torch.Tensor, torch.Tensor]:
    """YIN pitch track of (B, T) or (T,) waveforms, T a multiple of the hop
    → (f0 (B, T // hop) in Hz, 0 where unvoiced; voiced (B, T // hop)
    bool)."""
    w = cfg.frame_length
    cmnd, tau_min, tau_max, band = _cmnd_frames(y, cfg)
    cmnd_b = torch.where(band, cmnd, torch.full_like(cmnd, float("inf")))

    below = cmnd_b < cfg.threshold
    any_below = below.any(dim=-1)
    first_below = _first_true(below)
    # from the first crossing, the first tau where the CMND stops falling
    idx = torch.arange(w // 2 + 1, device=cmnd.device)
    after = idx >= first_below[..., None]
    rising = torch.cat([cmnd_b[..., 1:] >= cmnd_b[..., :-1],
                        torch.ones_like(below[..., :1])], dim=-1)
    local_min = _first_true(after & rising & band)
    best_tau = torch.where(any_below, local_min, torch.argmin(cmnd_b, dim=-1))

    # parabolic interpolation around best_tau
    t0 = torch.clamp(best_tau, tau_min, tau_max)

    def at(t):
        return torch.gather(cmnd, -1, torch.clamp(t, 0, w // 2)[..., None])[..., 0]

    dm, d0, dp = at(t0 - 1), at(t0), at(t0 + 1)
    denom = 2.0 * (dm - 2.0 * d0 + dp)
    shift = torch.where(denom.abs() > 1e-12,
                        (dm - dp) / torch.clamp(denom.abs(), min=1e-12) * torch.sign(denom),
                        torch.zeros_like(denom))
    period = t0.float() + torch.clamp(shift, -0.5, 0.5)

    f0 = torch.where(any_below, cfg.sample_rate / torch.clamp(period, min=1.0),
                     torch.zeros_like(period))
    f0 = torch.where((f0 >= cfg.f0_min) & (f0 <= cfg.f0_max), f0, torch.zeros_like(f0))
    return f0, f0 > 0
