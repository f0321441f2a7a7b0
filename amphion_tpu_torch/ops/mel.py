"""Mel spectrogram (port of `amphion_tpu/ops/mel.py`).

Same conventions as the JAX module: Slaney-normalised triangular
filterbank, reflect padding of ``(n_fft - hop)/2`` with center=False,
magnitude floor ``sqrt(. + 1e-6)``, ``log(clamp(x, clip))``, then the
config's dataset-level mean/var. `mel_spectrogram` runs the fused CUDA
kernel (`ops/kernels/csrc/mel.cu`) on a CUDA tensor, through `LogMelFn`
when autograd needs the signal's gradient (a GAN's mel loss);
`mel_spectrogram_ref` is the plain version, equal to the JAX
``mel_spectrogram_xla``. `linear_spectrogram` (VITS's posterior input) is
plain PyTorch on either device, as JAX computes it outside any Pallas
kernel: the windowed DFT of `ops/stft` as a strided float32 convolution.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from amphion_tpu_torch.ops.kernels.mel import LogMelFn, log_mel, log_mel_ref
from amphion_tpu_torch.ops.stft import _dft_kernel, _reflect_pad


@dataclass(frozen=True)
class MelConfig:
    """Front-end parameters (defaults = reference `config/base.json`)."""

    sample_rate: int = 24000
    n_fft: int = 1024
    win_size: int = 480
    hop_size: int = 120
    n_mel: int = 80
    fmin: float = 0.0
    fmax: float = 12000.0
    clip_val: float = 1e-5
    htk: bool = False
    mean: float = 0.0
    var: float = 1.0

    @classmethod
    def from_preprocess_cfg(cls, p: dict) -> "MelConfig":
        """Build from a ``preprocess`` config block."""
        return cls(
            sample_rate=p["sample_rate"], n_fft=p["n_fft"],
            win_size=p["win_size"], hop_size=p["hop_size"], n_mel=p["n_mel"],
            fmin=p["fmin"], fmax=p["fmax"],
            mean=float(p.get("mel_mean", 0.0)), var=float(p.get("mel_var", 1.0)))


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz, logstep = 1000.0, np.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz, logstep = 1000.0, np.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


@functools.lru_cache(maxsize=16)
def mel_filterbank(sample_rate: int, n_fft: int, n_mel: int, fmin: float,
                   fmax: float, htk: bool = False) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, (n_mel, n_fft//2+1)
    (``librosa.filters.mel(..., norm="slaney")``)."""
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    if htk:
        def hz2mel(f):
            return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

        def mel2hz(m):
            return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

        mel_pts = mel2hz(np.linspace(hz2mel(fmin), hz2mel(fmax), n_mel + 2))
    else:
        mel_pts = _mel_to_hz_slaney(np.linspace(
            _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mel + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_pts[2: n_mel + 2] - mel_pts[:n_mel]))[:, None]
    return weights.astype(np.float32)


def log_compression(x: torch.Tensor, clip_val: float = 1e-5,
                    c: float = 1.0) -> torch.Tensor:
    """Dynamic range compression ``log(clamp(x, clip) * C)``."""
    return torch.log(torch.clamp(x, min=clip_val) * c)


@functools.lru_cache(maxsize=8)
def _fbank(cfg: MelConfig, device: torch.device) -> torch.Tensor:
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mel, cfg.fmin,
                        cfg.fmax, cfg.htk)
    with torch.inference_mode(False):  # cached: a normal tensor whoever asks first
        return torch.from_numpy(fb).to(device)


def _standardize(mel: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Apply the config's dataset-level mean/var (no-op at the defaults)."""
    if cfg.mean == 0.0 and cfg.var == 1.0:
        return mel
    return (mel - cfg.mean) * (1.0 / math.sqrt(cfg.var))


def _as_batch(y: torch.Tensor) -> torch.Tensor:
    return (y[None] if y.ndim == 1 else y).float()


def mel_spectrogram(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Log-mel of (B, T) or (T,) float waveforms → (B, n_mel, T // hop).

    Runs the fused kernel on a CUDA tensor, its plain version on the CPU;
    differentiable in ``y`` (`LogMelFn`: the kernel forward, the plain
    version's backward)."""
    y = _as_batch(y)
    args = (_fbank(cfg, y.device), cfg.n_fft, cfg.hop_size, cfg.win_size, cfg.clip_val)
    if torch.is_grad_enabled() and y.requires_grad:
        mel = LogMelFn.apply(y, *args)
    else:
        mel = log_mel(y, *args)
    return _standardize(mel, cfg)


def mel_spectrogram_ref(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Plain PyTorch log-mel on any device (JAX ``mel_spectrogram_xla``)."""
    y = _as_batch(y)
    mel = log_mel_ref(y, _fbank(cfg, y.device), cfg.n_fft, cfg.hop_size,
                      cfg.win_size, cfg.clip_val)
    return _standardize(mel, cfg)


def linear_spectrogram(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Linear magnitude spectrogram of (B, T) or (T,) waveforms → (B,
    n_fft//2 + 1, T // hop): reflect padding of ``(n_fft − hop)/2``, the
    windowed DFT as a convolution of stride hop, ``sqrt(re² + im² + 1e-9)``.
    Float32 on the card needs `utils/device.strict_float32` (no TF32)."""
    y = _reflect_pad(_as_batch(y), (cfg.n_fft - cfg.hop_size) // 2)
    kernel = torch.from_numpy(_dft_kernel(cfg.n_fft, cfg.win_size)).to(y.device)
    out = F.conv1d(y[:, None, :], kernel[:, None, :], stride=cfg.hop_size)
    f = cfg.n_fft // 2 + 1
    re, im = out[:, :f], out[:, f:]
    return torch.sqrt(re * re + im * im + 1e-9)
