"""FastSpeech2 (port of `amphion_tpu/models/tts/fastspeech2/fs2.py`, the
ming024 lineage the reference checkpoints use):

- the legacy FFT encoder and decoder: post-LN attention with the residual
  inside (`LegacyMHA`), a conv FFN with the (k, 1) kernel pair, the
  sinusoid table added to the embeddings, padding zeroed after each block;
- `VarianceAdaptor`: duration, pitch and energy `VariancePredictor`s,
  pitch and energy quantised on stored bin boundaries (``pitch_bins``,
  ``energy_bins``, raw parameters, linear or log spaced by `_default_bins`)
  into embeddings at the phone or the frame level, and length regulation
  to ``max_frames`` (static);
- `Postnet`: five k5 convolutions with tanh, its BatchNorm kept as the
  per-channel affine ``bn_i_scale``/``bn_i_bias`` (raw parameters).

Layouts are JAX's (B, T, C); submodules carry the Flax scope names
(``phone_embed``, ``enc_i``, ``dec_i``, ``variance``, ``mel_out``,
``postnet.conv_i``, ``spk``). Dropout is left out: the JAX trainer applies
the model with ``deterministic=True``. Attention masks padded keys with
the dtype's lowest value, as JAX does; it is plain PyTorch (JAX computes
it as einsums, no Pallas kernel).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from amphion_tpu_torch.modules.duration import length_regulate
from amphion_tpu_torch.modules.transformer import conv_nlc, same_conv, sinusoidal_positions


@dataclass(frozen=True)
class FastSpeech2Config:
    num_phones: int = 512
    hidden: int = 256
    n_enc_layers: int = 4
    n_dec_layers: int = 6
    n_heads: int = 2
    ffn_hidden: int = 1024
    kernel_size: int = 9  # FFN conv_1 kernel; conv_2 is k=1
    n_mel: int = 80
    max_frames: int = 1000
    pitch_bins: int = 256
    energy_bins: int = 256
    pitch_min: float = -4.0  # normalized range
    pitch_max: float = 4.0
    energy_min: float = -4.0
    energy_max: float = 4.0
    pitch_quantization: str = "linear"  # or "log"
    energy_quantization: str = "linear"
    pitch_level: str = "frame"  # "frame" | "phoneme"
    energy_level: str = "frame"
    n_speakers: int = 0
    variance_hidden: int = 256
    variance_kernel: int = 3
    dropout: float = 0.2  # unused: the trainer runs deterministic


class LegacyMHA(nn.Module):
    """Separate q/k/v heads, scale 1/√d_k, padded keys filled with the
    lowest value, then ``LN(fc(attn) + x)``."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.w_qs = nn.Linear(channels, channels)
        self.w_ks = nn.Linear(channels, channels)
        self.w_vs = nn.Linear(channels, channels)
        self.fc = nn.Linear(channels, channels)
        self.layer_norm = nn.LayerNorm(channels, eps=1e-5)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        b, t, d = x.shape
        nh, dk = self.num_heads, d // self.num_heads
        q = self.w_qs(x).reshape(b, t, nh, dk)
        k = self.w_ks(x).reshape(b, t, nh, dk)
        v = self.w_vs(x).reshape(b, t, nh, dk)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(dk)
        if mask is not None:
            scores = torch.where(mask[:, None, None, :] > 0, scores,
                                 torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, d)
        return self.layer_norm(self.fc(out) + x)


class LegacyFFTBlock(nn.Module):
    """`LegacyMHA` then the conv-(k, 1) FFN, post-LN, padding zeroed after
    each sublayer."""

    def __init__(self, channels: int, num_heads: int, ffn_hidden: int, kernel_size: int = 9):
        super().__init__()
        self.slf_attn = LegacyMHA(channels, num_heads)
        self.w_1 = same_conv(channels, ffn_hidden, kernel_size)
        self.w_2 = nn.Conv1d(ffn_hidden, channels, 1)
        self.ffn_ln = nn.LayerNorm(channels, eps=1e-5)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.slf_attn(x, mask)
        if mask is not None:
            x = x * mask[..., None]
        h = conv_nlc(self.w_2, torch.relu(conv_nlc(self.w_1, x)))
        x = self.ffn_ln(h + x)
        if mask is not None:
            x = x * mask[..., None]
        return x


class VariancePredictor(nn.Module):
    """conv-ReLU-LN ×2 and a Dense → (B, T), masked. The second conv pads
    (1, 1) whatever the kernel, as the reference hard-codes it."""

    def __init__(self, in_channels: int, hidden: int, kernel_size: int = 3):
        super().__init__()
        self.conv1d_1 = same_conv(in_channels, hidden, kernel_size)
        self.layer_norm_1 = nn.LayerNorm(hidden, eps=1e-5)
        self.conv1d_2 = nn.Conv1d(hidden, hidden, kernel_size, padding=1)
        self.layer_norm_2 = nn.LayerNorm(hidden, eps=1e-5)
        self.linear_layer = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.layer_norm_1(torch.relu(conv_nlc(self.conv1d_1, x)))
        x = self.layer_norm_2(torch.relu(conv_nlc(self.conv1d_2, x)))
        out = self.linear_layer(x)[..., 0]
        return out if mask is None else out * mask


def _default_bins(lo, hi, n, quantization) -> np.ndarray:
    if quantization == "log":
        return np.exp(np.linspace(np.log(max(lo, 1e-5)), np.log(hi), n - 1))
    return np.linspace(lo, hi, n - 1)


class VarianceAdaptor(nn.Module):
    """Duration, pitch and energy prediction, bucketised embeddings and
    length regulation → (x (B, max_frames, H), frame mask (B, max_frames)
    float, predictions)."""

    def __init__(self, cfg: FastSpeech2Config):
        super().__init__()
        self.cfg = c = cfg
        self.pitch_bins = nn.Parameter(torch.empty(c.pitch_bins - 1))
        self.energy_bins = nn.Parameter(torch.empty(c.energy_bins - 1))
        self.flax_init_(None)
        self.pitch_embedding = nn.Embedding(c.pitch_bins, c.hidden)
        self.energy_embedding = nn.Embedding(c.energy_bins, c.hidden)
        for name in ("duration_predictor", "pitch_predictor", "energy_predictor"):
            self.add_module(name, VariancePredictor(c.hidden, c.variance_hidden,
                                                    c.variance_kernel))

    @torch.no_grad()
    def flax_init_(self, generator: torch.Generator | None) -> None:
        """The bins' initial boundaries (`_default_bins`, no draw)."""
        c = self.cfg
        for p, lo, hi, n, q in ((self.pitch_bins, c.pitch_min, c.pitch_max, c.pitch_bins,
                                 c.pitch_quantization),
                                (self.energy_bins, c.energy_min, c.energy_max, c.energy_bins,
                                 c.energy_quantization)):
            p.copy_(torch.from_numpy(_default_bins(lo, hi, n, q).astype(np.float32)))

    def _add(self, kind: str, h, mask, target, control):
        pred = getattr(self, f"{kind}_predictor")(h, mask)
        tgt = target if target is not None else pred * control
        bins = getattr(self, f"{kind}_bins")
        emb = getattr(self, f"{kind}_embedding")
        return pred, h + emb(torch.searchsorted(bins.detach(), tgt.contiguous()))

    def forward(self, x, phone_mask, durations=None, pitch=None, energy=None,
                d_control: float = 1.0, p_control: float = 1.0, e_control: float = 1.0):
        c = self.cfg
        log_d_pred = self.duration_predictor(x, phone_mask)
        pitch_pred = energy_pred = None
        if c.pitch_level == "phoneme":
            pitch_pred, x = self._add("pitch", x, phone_mask, pitch, p_control)
        if c.energy_level == "phoneme":
            energy_pred, x = self._add("energy", x, phone_mask, energy, e_control)
        if durations is None:
            durations = torch.clamp(torch.round((torch.exp(log_d_pred) - 1.0) * d_control),
                                    min=0.0).to(torch.int32)
            durations = durations * phone_mask.to(torch.int32)
        x, frame_mask = length_regulate(x, durations, c.max_frames)
        fmask = frame_mask.float()
        if c.pitch_level == "frame":
            pitch_pred, x = self._add("pitch", x, fmask, pitch, p_control)
        if c.energy_level == "frame":
            energy_pred, x = self._add("energy", x, fmask, energy, e_control)
        return x, fmask, {"log_duration_pred": log_d_pred, "pitch_pred": pitch_pred,
                          "energy_pred": energy_pred}


class Postnet(nn.Module):
    """Five k5 convolutions without bias, each followed by the per-channel
    affine ``bn_i`` (tanh after the first four), added to the input."""

    def __init__(self, n_mel: int, hidden: int = 512):
        super().__init__()
        widths = [n_mel] + [hidden] * 4 + [n_mel]
        for i in range(5):
            self.add_module(f"conv_{i}", same_conv(widths[i], widths[i + 1], 5, bias=False))
            self.register_parameter(f"bn_{i}_scale", nn.Parameter(torch.ones(widths[i + 1])))
            self.register_parameter(f"bn_{i}_bias", nn.Parameter(torch.zeros(widths[i + 1])))

    @torch.no_grad()
    def flax_init_(self, generator: torch.Generator) -> None:
        for i in range(5):
            getattr(self, f"bn_{i}_scale").fill_(1.0)
            getattr(self, f"bn_{i}_bias").zero_()

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel
        for i in range(5):
            x = conv_nlc(getattr(self, f"conv_{i}"), x)
            x = x * getattr(self, f"bn_{i}_scale") + getattr(self, f"bn_{i}_bias")
            if i < 4:
                x = torch.tanh(x)
        return mel + x


class FastSpeech2(nn.Module):
    def __init__(self, cfg: FastSpeech2Config):
        super().__init__()
        self.cfg = c = cfg
        self.phone_embed = nn.Embedding(c.num_phones, c.hidden)
        for i in range(c.n_enc_layers):
            self.add_module(f"enc_{i}", LegacyFFTBlock(c.hidden, c.n_heads, c.ffn_hidden,
                                                       c.kernel_size))
        if c.n_speakers > 1:
            self.spk = nn.Embedding(c.n_speakers, c.hidden)
        self.variance = VarianceAdaptor(c)
        for i in range(c.n_dec_layers):
            self.add_module(f"dec_{i}", LegacyFFTBlock(c.hidden, c.n_heads, c.ffn_hidden,
                                                       c.kernel_size))
        self.mel_out = nn.Linear(c.hidden, c.n_mel)
        self.postnet = Postnet(c.n_mel)

    def _positions(self, length: int, like: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(sinusoidal_positions(length, self.cfg.hidden)).to(like.device)

    def forward(self, phones, phone_mask, durations=None, pitch=None, energy=None, sid=None,
                d_control: float = 1.0) -> dict:
        """Phones (B, L) → mel (B, max_frames, n_mel) before and after the
        Postnet, the frame mask and the variance predictions. Given
        ``durations`` (B, L), ``pitch`` and ``energy`` (B, max_frames) are
        the teacher-forced targets (training); else all are predicted."""
        c = self.cfg
        x = self.phone_embed(phones)
        x = x + self._positions(phones.shape[1], x)[None]
        for i in range(c.n_enc_layers):
            x = getattr(self, f"enc_{i}")(x, phone_mask)
        if c.n_speakers > 1 and sid is not None:
            x = x + self.spk(sid)[:, None, :]
        x, fmask, var = self.variance(x, phone_mask, durations, pitch, energy, d_control)
        x = x + self._positions(x.shape[1], x)[None]
        for i in range(c.n_dec_layers):
            x = getattr(self, f"dec_{i}")(x, fmask)
        mel = self.mel_out(x)
        return {"mel": mel, "mel_postnet": self.postnet(mel), "frame_mask": fmask, **var}


def fastspeech2_loss(out: dict, batch: dict) -> tuple[torch.Tensor, dict]:
    """L1 mel and post-net mel, MSE log-duration, pitch and energy, each
    over its mask → (total, parts)."""
    fmask = out["frame_mask"][..., None]
    pmask = batch["phone_mask"]
    n_mel = batch["mel"].shape[-1]
    denom_f = torch.clamp(torch.sum(fmask), min=1.0)
    mel_l = torch.sum(torch.abs(out["mel"] - batch["mel"]) * fmask) / (denom_f * n_mel)
    post_l = torch.sum(torch.abs(out["mel_postnet"] - batch["mel"]) * fmask) / (denom_f * n_mel)
    log_d_tgt = torch.log(batch["durations"].float() + 1.0)
    dur_l = torch.sum(((out["log_duration_pred"] - log_d_tgt) ** 2) * pmask) / torch.clamp(
        torch.sum(pmask), min=1.0)
    fm = out["frame_mask"]
    pitch_l = torch.sum(((out["pitch_pred"] - batch["pitch"]) ** 2) * fm) / denom_f
    energy_l = torch.sum(((out["energy_pred"] - batch["energy"]) ** 2) * fm) / denom_f
    total = mel_l + post_l + dur_l + pitch_l + energy_l
    return total, {"mel": mel_l, "mel_post": post_l, "dur": dur_l, "pitch": pitch_l,
                   "energy": energy_l}
