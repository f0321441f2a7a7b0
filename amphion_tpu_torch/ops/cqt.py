"""Constant-Q transform over several octaves (port of `amphion_tpu/ops/cqt.py`),
the front end of the MS-SB-CQT discriminator.

Complex CQT kernels are designed once, in float64 numpy, for the top
octave alone, where they are short: Hann-windowed complex exponentials,
L1-normalised, with the librosa-style ``sqrt(kernel length)`` scaling.
Each lower octave reuses them on a 2× anti-alias-decimated copy of the
signal at half the hop. Each octave is a matrix product of the framed,
zero-padded signal with the (n_fft, 2·bins) kernel matrix; the
decimation is a strided 256-tap FIR. On the card both are float32 with
TF32 off (`utils/device.strict_float32`); JAX computes them in XLA, outside
any Pallas kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from amphion_tpu_torch.ops.stft import frame_signal


@functools.lru_cache(maxsize=16)
def _octave_kernels(sr: float, fmin_t: float, bins_per_octave: int,
                    filter_scale: float = 1.0):
    """(real, imag) kernel banks (bins_per_octave, n_fft) of the octave
    starting at ``fmin_t``, the per-bin window lengths, and n_fft (the
    next power of two of the longest)."""
    q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = fmin_t * 2.0 ** (np.arange(bins_per_octave) / bins_per_octave)
    if freqs[-1] * (1.0 + 0.5 / q) > sr / 2.0:
        raise ValueError(f"top CQT bin {freqs[-1]:.1f} Hz exceeds Nyquist {sr / 2:.1f} Hz")
    lengths = np.ceil(q * sr / freqs).astype(np.int64)
    n_fft = int(2 ** math.ceil(math.log2(lengths.max())))
    kr = np.zeros((bins_per_octave, n_fft), np.float64)
    ki = np.zeros((bins_per_octave, n_fft), np.float64)
    for k, (f, n) in enumerate(zip(freqs, lengths)):
        n = int(n)
        start = int(math.ceil(n_fft / 2.0 - n / 2.0))
        t = np.arange(n) - (n + 1) // 2  # centred support
        win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)  # periodic Hann
        sig = win * np.exp(2j * np.pi * f * t / sr)
        sig = sig / np.sum(np.abs(sig))  # L1 norm
        kr[k, start:start + n] = sig.real
        ki[k, start:start + n] = sig.imag
    return (kr.astype(np.float32), ki.astype(np.float32), lengths.astype(np.float32), n_fft)


@functools.lru_cache(maxsize=4)
def _halfband_taps(n_taps: int = 256, transition: float = 0.001) -> np.ndarray:
    """Kaiser-windowed sinc low-pass at a quarter of the sample rate, for ÷2
    decimation."""
    cutoff = 0.25 * (1.0 - transition)  # cycles/sample
    n = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * n)
    h *= np.kaiser(n_taps, 9.0)
    return (h / h.sum()).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_bases(device: torch.device, sr: float, fmin_t: float, bins_per_octave: int,
                  filter_scale: float):
    """The top octave's (n_fft, 2·bins) kernel matrix, its per-bin
    ``sqrt(length)`` scale and n_fft, and the halfband taps, on ``device``:
    built and copied once, so a forward makes no host-to-device copy."""
    kr, ki, lengths, n_fft = _octave_kernels(sr, fmin_t, bins_per_octave, filter_scale)
    with torch.inference_mode(False):  # cached: a normal tensor whoever asks first
        kmat = torch.from_numpy(np.ascontiguousarray(np.concatenate([kr, -ki], axis=0).T))
        scale = torch.from_numpy(np.sqrt(lengths))
        return kmat.to(device), scale.to(device), n_fft, _device_taps(device)


@functools.lru_cache(maxsize=4)
def _device_taps(device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(_halfband_taps()).to(device)


def _downsample2(x: torch.Tensor, taps: torch.Tensor | None = None) -> torch.Tensor:
    """Anti-aliased ÷2 decimation of (B, T) → (B, ceil(T/2)), by the
    halfband ``taps`` (on ``x``'s device; built when not given)."""
    if taps is None:
        taps = _device_taps(x.device)
    n = taps.shape[0]
    xp = F.pad(x[:, None].float(), (n // 2, n // 2 - 1))
    return F.conv1d(xp, taps[None, None], stride=2)[:, 0]


def cqt(x: torch.Tensor, sr: int, hop_length: int, fmin: float = 32.70, n_bins: int = 216,
        bins_per_octave: int = 24, filter_scale: float = 1.0,
        output: str = "complex") -> torch.Tensor:
    """Multi-octave CQT of (B, T) audio at ``sr`` Hz; ``hop_length`` is the
    top octave's and must be divisible by 2^(octaves − 1). ``output``
    "complex" → (B, n_bins, frames, 2) (real, imag), "magnitude" → (B,
    n_bins, frames). Bins run from low to high, bin 0 at ``fmin``."""
    n_oct = math.ceil(n_bins / bins_per_octave)
    if hop_length % (2 ** (n_oct - 1)) != 0:
        raise ValueError(f"hop_length {hop_length} must be divisible by 2^{n_oct - 1}")
    kmat, scale, n_fft, taps = _device_bases(  # kmat: (n_fft, 2·bpo)
        x.device, float(sr), float(fmin * 2.0 ** (n_oct - 1)), bins_per_octave,
        float(filter_scale))

    octaves = []  # the top octave first
    xi, hop = x.float(), hop_length
    for i in range(n_oct):
        if i > 0:
            xi, hop = _downsample2(xi, taps), hop // 2
        frames = frame_signal(F.pad(xi, (n_fft // 2, n_fft // 2)), n_fft, hop)
        out = frames @ kmat  # (B, F, 2·bpo)
        o = torch.stack([out[..., :bins_per_octave], out[..., bins_per_octave:]], dim=-1)
        octaves.append((o * scale[None, None, :, None]).transpose(1, 2))  # (B, bpo, F, 2)

    n_frames = min(o.shape[2] for o in octaves)
    full = torch.cat([o[:, :, :n_frames] for o in octaves[::-1]], dim=1)
    if full.shape[1] > n_bins:
        full = full[:, -n_bins:]
    if output == "magnitude":
        return torch.sqrt(torch.sum(full * full, dim=-1) + 1e-12)
    return full
