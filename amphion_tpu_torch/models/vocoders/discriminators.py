"""GAN vocoder discriminators (port of the MPD, MSD and MRD of
`amphion_tpu/models/vocoders/discriminators.py`).

Each discriminator maps a batch of waveforms (B, T) to one logit tensor
(B, n) and one list of feature maps per sub-discriminator, for the LSGAN
and feature-matching losses (`models/vocoders/losses.py`). Every
convolution is weight-normalised with Flax's rules
(`modules/weight_norm.py`), and the submodules carry the Flax scope names
(``PeriodDiscriminator_2.Conv_3``), so `utils/convert.from_flax` carries a
JAX tree over and `init_like_flax` draws as Flax does.

Layouts: MPD and MRD run 2-D convolutions in torch's (B, C, H, W) and
return their feature maps so (JAX's are (B, H, W, C)); MSD's 1-D maps are
(B, T, C) as in JAX. The logits are flattened in JAX's order. The losses
are means over whole maps, so the layout does not change them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from amphion_tpu_torch.modules.weight_norm import WNConv1d, WNConv2d

LRELU_SLOPE = 0.1


class PeriodDiscriminator(nn.Module):
    """One period branch of MPD: reflect-pad T to a multiple of the period,
    fold to (T/p, p), five (5, 1) convolutions of stride (3, 1), then a
    (3, 1) one."""

    CHANNELS = (32, 128, 512, 1024, 1024)

    def __init__(self, period: int, channel_mult: float = 1.0):
        super().__init__()
        self.period = period
        prev = 1
        for i, ch in enumerate(self.CHANNELS):
            ch = int(ch * channel_mult)
            self.add_module(f"Conv_{i}", WNConv2d(prev, ch, (5, 1), (3, 1), (2, 0)))
            prev = ch
        n = len(self.CHANNELS)
        self.add_module(f"Conv_{n}", WNConv2d(prev, 1, (3, 1), padding=(1, 0)))
        self.convs = [getattr(self, f"Conv_{i}") for i in range(n + 1)]

    def forward(self, x: torch.Tensor):
        b, t = x.shape
        p = self.period
        pad = (-t) % p
        if pad:
            x = F.pad(x[:, None], (0, pad), mode="reflect")[:, 0]
        h = x.reshape(b, 1, (t + pad) // p, p)
        fmap = []
        for conv in self.convs[:-1]:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.convs[-1](h)
        fmap.append(h)
        return h.reshape(b, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: tuple[int, ...] = (2, 3, 5, 7, 11), channel_mult: float = 1.0):
        super().__init__()
        for i, p in enumerate(periods):
            self.add_module(f"PeriodDiscriminator_{i}", PeriodDiscriminator(p, channel_mult))
        self.subs = [getattr(self, f"PeriodDiscriminator_{i}") for i in range(len(periods))]

    def forward(self, x: torch.Tensor):
        logits, fmaps = [], []
        for d in self.subs:
            lo, fm = d(x)
            logits.append(lo)
            fmaps.append(fm)
        return logits, fmaps


class ScaleDiscriminator(nn.Module):
    """One scale branch of MSD: seven grouped 1-D convolutions with an
    explicit symmetric k//2 padding, then a 3-tap one."""

    LAYERS = (  # (channels, kernel, stride, groups)
        (128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
        (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1),
    )

    def __init__(self, channel_mult: float = 1.0):
        super().__init__()
        prev = 1
        for i, (ch, k, s, g) in enumerate(self.LAYERS):
            ch = max(g, int(ch * channel_mult))
            g = math.gcd(g, math.gcd(prev, ch))
            self.add_module(f"Conv_{i}", WNConv1d(prev, ch, k, stride=s,
                                                  padding=(k // 2, k // 2), groups=g))
            prev = ch
        n = len(self.LAYERS)
        self.add_module(f"Conv_{n}", WNConv1d(prev, 1, 3, padding=(1, 1)))
        self.convs = [getattr(self, f"Conv_{i}") for i in range(n + 1)]

    def forward(self, x: torch.Tensor):
        b = x.shape[0]
        h = x[..., None]
        fmap = []
        for conv in self.convs[:-1]:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.convs[-1](h)
        fmap.append(h)
        return h.reshape(b, -1), fmap


class MultiScaleDiscriminator(nn.Module):
    """MSD over the raw audio and its 2x, 4x, ... average-pooled versions
    (``AvgPool1d(4, 2, padding=2)``, the zero padding counted)."""

    def __init__(self, num_scales: int = 3, channel_mult: float = 1.0):
        super().__init__()
        for i in range(num_scales):
            self.add_module(f"ScaleDiscriminator_{i}", ScaleDiscriminator(channel_mult))
        self.subs = [getattr(self, f"ScaleDiscriminator_{i}") for i in range(num_scales)]

    def forward(self, x: torch.Tensor):
        logits, fmaps = [], []
        h = x
        for i, d in enumerate(self.subs):
            if i > 0:
                h = F.avg_pool1d(h[:, None], 4, 2, padding=2)[:, 0]
            lo, fm = d(h)
            logits.append(lo)
            fmaps.append(fm)
        return logits, fmaps


def mrd_spectrogram(x: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """(B, T) → |STFT| (B, n_fft//2 + 1, frames): reflect padding of
    (n_fft − hop)/2, no centring, a rectangular window of length ``win``
    centred in n_fft, no epsilon under the magnitude."""
    p = (n_fft - hop) // 2
    x = F.pad(x[:, None], (p, p), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)  # (B, N, n_fft)
    w = torch.zeros(n_fft, device=x.device, dtype=x.dtype)
    left = (n_fft - win) // 2
    w[left: left + win] = 1.0
    return torch.fft.rfft(frames * w, dim=-1).abs().transpose(1, 2)


class ResolutionDiscriminator(nn.Module):
    """One resolution of MRD: 2-D convolutions over the (frequency, time)
    magnitude image, 32 channels: (3, 9) with stride (1, 2) on time, then two
    (3, 3). (JAX's ``channel_mult`` field is never set: the combined
    discriminator does not pass its multiplier to MRD.)"""

    def __init__(self, n_fft: int, hop: int, win: int):
        super().__init__()
        self.n_fft, self.hop, self.win = n_fft, hop, win
        ch = 32
        for i in range(4):
            self.add_module(f"Conv_{i}", WNConv2d(1 if i == 0 else ch, ch, (3, 9),
                                                  (1, 2) if i > 0 else (1, 1), (1, 4)))
        self.Conv_4 = WNConv2d(ch, ch, (3, 3), padding=(1, 1))
        self.Conv_5 = WNConv2d(ch, 1, (3, 3), padding=(1, 1))
        self.convs = [getattr(self, f"Conv_{i}") for i in range(6)]

    def forward(self, x: torch.Tensor):
        h = mrd_spectrogram(x, self.n_fft, self.hop, self.win)[:, None]  # (B, 1, F, N)
        b = h.shape[0]
        fmap = []
        for conv in self.convs[:-1]:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.convs[-1](h)
        fmap.append(h)
        return h.reshape(b, -1), fmap


MRD_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


class MultiResolutionDiscriminator(nn.Module):
    """MRD over several (n_fft, hop, win) resolutions."""

    def __init__(self, resolutions: tuple[tuple[int, int, int], ...] = MRD_RESOLUTIONS):
        super().__init__()
        for i, (n_fft, hop, win) in enumerate(resolutions):
            self.add_module(f"ResolutionDiscriminator_{i}",
                            ResolutionDiscriminator(n_fft, hop, win))
        self.subs = [getattr(self, f"ResolutionDiscriminator_{i}")
                     for i in range(len(resolutions))]

    def forward(self, x: torch.Tensor):
        logits, fmaps = [], []
        for d in self.subs:
            lo, fm = d(x)
            logits.append(lo)
            fmaps.append(fm)
        return logits, fmaps
