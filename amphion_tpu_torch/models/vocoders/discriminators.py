"""GAN vocoder discriminators (port of the MPD, MSD, MRD, MS-STFT and
MS-SB-CQT of `amphion_tpu/models/vocoders/discriminators.py`).

Each discriminator maps a batch of waveforms (B, T) to one logit tensor
(B, n) and one list of feature maps per sub-discriminator, for the LSGAN
and feature-matching losses (`models/vocoders/losses.py`). Every
convolution is weight-normalised with Flax's rules
(`modules/weight_norm.py`), and the submodules carry the Flax scope names
(``PeriodDiscriminator_2.Conv_3``), so `utils/convert.from_flax` carries a
JAX tree over and `init_like_flax` draws as Flax does.

Layouts: the 2-D discriminators run their convolutions in torch's (B, C,
H, W) and return their feature maps so (JAX's are (B, H, W, C)); MSD's 1-D
maps are (B, T, C) as in JAX. MS-STFT's and MS-SB-CQT's images are (time,
frequency), their first convolutions (and the CQT's per-octave ones) plain
``nn.Conv2d``, as in JAX. The logits are flattened in JAX's order. The losses
are means over whole maps, so the layout does not change them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from amphion_tpu_torch.modules.anti_aliasing import upsample1d
from amphion_tpu_torch.modules.weight_norm import WNConv1d, WNConv2d
from amphion_tpu_torch.ops.cqt import cqt
from amphion_tpu_torch.ops.stft import hann_window, stft

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


def _run(convs: list[nn.Module], h: torch.Tensor, slope: float):
    """Each conv but the last followed by a leaky ReLU whose output is a
    feature map; the last's output flattened is the logit → (logits, fmaps)."""
    fmap = []
    for conv in convs[:-1]:
        h = F.leaky_relu(conv(h), slope)
        fmap.append(h)
    return convs[-1](h).reshape(h.shape[0], -1), fmap


class STFTDiscriminator(nn.Module):
    """One resolution of MS-STFT (the EnCodec discriminator): the
    window-normalised complex STFT (``center=False``) as a 2-channel (re,
    im) (time, frequency) image, a plain (3, 9) conv, three weight-normed
    (3, 9) convs of stride 2 in frequency and dilation 1, 2, 4 in time, a
    (3, 3) one, each followed by a leaky ReLU (0.2), then a (3, 3) conv to
    one channel (not a feature map)."""

    def __init__(self, n_fft: int, hop: int, win: int, channels: int = 32):
        super().__init__()
        self.n_fft, self.hop, self.win = n_fft, hop, win
        self.scale = 1.0 / float(np.sqrt(np.sum(hann_window(win) ** 2)))
        self.conv_0 = nn.Conv2d(2, channels, (3, 9), padding=(1, 4))
        for i, d in enumerate((1, 2, 4)):
            self.add_module(f"conv_{i + 1}", WNConv2d(channels, channels, (3, 9), (1, 2),
                                                      (d, 4), (d, 1)))
        self.conv_4 = WNConv2d(channels, channels, (3, 3), padding=(1, 1))
        self.conv_post = WNConv2d(channels, 1, (3, 3), padding=(1, 1))
        self.convs = [getattr(self, f"conv_{i}") for i in range(5)] + [self.conv_post]

    def forward(self, x: torch.Tensor):
        re, im = stft(x, self.n_fft, self.hop, self.win, center=False)  # (B, F, N)
        h = torch.stack([re, im], dim=1).transpose(2, 3) * self.scale  # (B, 2, N, F)
        return _run(self.convs, h, 0.2)


class MultiSTFTDiscriminator(nn.Module):
    """MS-STFT over several (n_fft, hop, win) resolutions."""

    def __init__(self, resolutions: tuple[tuple[int, int, int], ...] = (
            (1024, 256, 1024), (2048, 512, 2048), (512, 256, 512)), channels: int = 32):
        super().__init__()
        for i, (n_fft, hop, win) in enumerate(resolutions):
            self.add_module(f"STFTDiscriminator_{i}",
                            STFTDiscriminator(n_fft, hop, win, channels))
        self.subs = [getattr(self, f"STFTDiscriminator_{i}") for i in range(len(resolutions))]

    def forward(self, x: torch.Tensor):
        logits, fmaps = [], []
        for d in self.subs:
            lo, fm = d(x)
            logits.append(lo)
            fmaps.append(fm)
        return logits, fmaps


class SubBandCQTDiscriminator(nn.Module):
    """One scale of MS-SB-CQT: the audio upsampled 2× (`upsample1d`), its
    complex CQT at twice the sample rate (`ops/cqt.cqt`) as a 2-channel (re,
    im) (time, frequency) image, a plain (3, 9) conv per octave sub-band
    (``conv_pre_i``, concatenated back along frequency, no activation), a
    plain (3, 9) conv, weight-normed (3, 9) convs of stride 2 in frequency
    and dilation ``dilations`` in time, a (3, 3) one, each followed by a
    leaky ReLU (0.1) whose output is a feature map, then a (3, 3) conv to
    ``out_channels``."""

    def __init__(self, sample_rate: int, hop_length: int, n_octaves: int = 9,
                 bins_per_octave: int = 24, fmin: float = 32.70, filters: int = 32,
                 max_filters: int = 1024, filters_scale: int = 1,
                 dilations: tuple[int, ...] = (1, 2, 4), in_channels: int = 1,
                 out_channels: int = 1):
        super().__init__()
        self.sample_rate, self.hop_length, self.fmin = sample_rate, hop_length, fmin
        self.n_octaves, self.bins_per_octave = n_octaves, bins_per_octave
        for i in range(n_octaves):
            self.add_module(f"conv_pre_{i}", nn.Conv2d(2 * in_channels, 2 * in_channels,
                                                       (3, 9), padding=(1, 4)))
        self.pre = [getattr(self, f"conv_pre_{i}") for i in range(n_octaves)]
        self.conv_0 = nn.Conv2d(2 * in_channels, filters, (3, 9), padding=(1, 4))
        prev = filters
        for i, d in enumerate(dilations):
            ch = min(filters_scale ** (i + 1) * filters, max_filters)
            self.add_module(f"conv_{i + 1}", WNConv2d(prev, ch, (3, 9), (1, 2), (d, 4), (d, 1)))
            prev = ch
        n = len(dilations) + 1
        ch = min(filters_scale ** n * filters, max_filters)
        self.add_module(f"conv_{n}", WNConv2d(prev, ch, (3, 3), padding=(1, 1)))
        self.conv_post = WNConv2d(ch, out_channels, (3, 3), padding=(1, 1))
        self.convs = [getattr(self, f"conv_{i}") for i in range(n + 1)] + [self.conv_post]

    def forward(self, x: torch.Tensor):
        x2 = upsample1d(x[..., None], ratio=2)[..., 0]
        z = cqt(x2, sr=2 * self.sample_rate, hop_length=self.hop_length, fmin=self.fmin,
                n_bins=self.bins_per_octave * self.n_octaves,
                bins_per_octave=self.bins_per_octave)  # (B, W, T, 2)
        h = z.permute(0, 3, 2, 1)  # (B, 2, T, W)
        bpo = self.bins_per_octave
        h = torch.cat([conv(h[..., i * bpo:(i + 1) * bpo]) for i, conv in enumerate(self.pre)],
                      dim=3)
        return _run(self.convs, h, LRELU_SLOPE)


class MultiScaleSubBandCQTDiscriminator(nn.Module):
    """MS-SB-CQT over (hop, octaves, bins per octave) scales; the defaults
    are the reference recipe's."""

    def __init__(self, sample_rate: int = 24000, hops: tuple[int, ...] = (512, 256, 256),
                 n_octaves: tuple[int, ...] = (9, 9, 9),
                 bins_per_octaves: tuple[int, ...] = (24, 36, 48)):
        super().__init__()
        for i, (hop, n_oct, bpo) in enumerate(zip(hops, n_octaves, bins_per_octaves)):
            self.add_module(f"SubBandCQTDiscriminator_{i}", SubBandCQTDiscriminator(
                sample_rate, hop, n_octaves=n_oct, bins_per_octave=bpo))
        self.subs = [getattr(self, f"SubBandCQTDiscriminator_{i}") for i in range(len(hops))]

    def forward(self, x: torch.Tensor):
        logits, fmaps = [], []
        for d in self.subs:
            lo, fm = d(x)
            logits.append(lo)
            fmaps.append(fm)
        return logits, fmaps
