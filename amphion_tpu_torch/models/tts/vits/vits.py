"""VITS: end-to-end VAE + flow + adversarial TTS (port of
`amphion_tpu/models/tts/vits/vits.py`).

The text encoder (relative-position transformer, `modules/transformer`),
the posterior encoder (a 16-layer WaveNet over the linear spectrogram), the
coupling-flow prior (`modules/flows`), monotonic alignment search
(`ops/mas`, on the device), the stochastic duration predictor
(`modules/duration`) and the HiFi-GAN waveform decoder (the port's
`HiFiGANGenerator`, speaker-conditioned through ``cond`` when the model
has speakers). Layouts are JAX's (B, T, C); submodules carry the Flax
scope names (``text_encoder.emb``, ``posterior.enc``, ``flow.flow_i``,
``duration_predictor.post_flow_0``, ``speaker_embed``, ``decoder.cond``),
so `utils/convert.from_flax` carries a JAX tree over.

JAX splits one key a call into the draws; the port takes each draw from
the caller or, where it is not given, from ``generator``:

- `VITS.train_forward`: ``noise`` (the posterior's, (B, T_spec, inter)),
  ``e_q`` (the duration posterior's, (B, L, 2)) and ``segment_start`` (B,)
  (else ``⌊u · (max_start + 1)⌋`` of a uniform ``u``, as JAX draws it);
- `VITS.infer`: ``dur_noise`` (B, L, 2) and ``z_noise`` (B, max_frames,
  inter).

As in JAX, the speaker conditioning (``cond`` of the posterior's WaveNet,
of each flow's, of the duration predictor and of the decoder) exists only
where the model has speakers (``n_speakers > 1``), and the stochastic
predictor's filter width is its hidden width (``filter_channels`` is the
text encoder's alone).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
from torch import nn

from amphion_tpu_torch.models.vocoders.hifigan import HiFiGANConfig, HiFiGANGenerator
from amphion_tpu_torch.modules.duration import (
    DurationPredictor,
    StochasticDurationPredictor,
    length_regulate,
)
from amphion_tpu_torch.modules.flows import WN, ResidualCouplingBlock
from amphion_tpu_torch.modules.transformer import TransformerEncoder, conv_nlc
from amphion_tpu_torch.ops.mas import maximum_path


@dataclass(frozen=True)
class VITSConfig:
    num_phones: int = 512
    spec_channels: int = 513  # n_fft//2 + 1
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    n_speakers: int = 0
    gin_channels: int = 256
    use_sdp: bool = True
    segment_size: int = 32  # latent frames fed to the waveform decoder
    decoder: HiFiGANConfig = field(default_factory=lambda: HiFiGANConfig(
        resblock="1", upsample_rates=(5, 4, 3, 2), upsample_kernel_sizes=(10, 8, 6, 4),
        upsample_initial_channel=512, n_mel=192))

    @property
    def gin(self) -> int:
        """The speaker-conditioning width the submodules are built with: 0
        for a single-speaker model, which JAX gives no conditioning."""
        return self.gin_channels if self.n_speakers > 1 else 0


class TextEncoder(nn.Module):
    def __init__(self, cfg: VITSConfig):
        super().__init__()
        c = cfg
        self.hidden = c.hidden_channels
        self.emb = nn.Embedding(c.num_phones, c.hidden_channels)
        self.encoder = TransformerEncoder(c.hidden_channels, c.n_heads, c.n_layers,
                                          c.filter_channels, c.kernel_size, window_size=4)
        self.proj = nn.Linear(c.hidden_channels, 2 * c.inter_channels)

    def forward(self, phones: torch.Tensor, phone_mask: torch.Tensor):
        """→ (x (B, L, H), m_p, logs_p (B, L, inter))."""
        x = self.emb(phones) * math.sqrt(self.hidden)
        x = self.encoder(x, phone_mask)
        m, logs = self.proj(x).chunk(2, dim=-1)
        return x, m, logs


class PosteriorEncoder(nn.Module):
    def __init__(self, cfg: VITSConfig):
        super().__init__()
        c = cfg
        self.pre = nn.Conv1d(c.spec_channels, c.hidden_channels, 1)
        self.enc = WN(c.hidden_channels, 5, 1, 16, gin_channels=c.gin)
        self.proj = nn.Linear(c.hidden_channels, 2 * c.inter_channels)

    def forward(self, spec: torch.Tensor, spec_mask: torch.Tensor,
                g: torch.Tensor | None = None, noise: torch.Tensor | None = None):
        """spec (B, T, F) → (z, m_q, logs_q (B, T, inter)); ``noise`` None
        gives the posterior mean."""
        x = conv_nlc(self.pre, spec) * spec_mask[..., None]
        x = self.enc(x, spec_mask, g=g)
        m, logs = self.proj(x).chunk(2, dim=-1)
        z = m if noise is None else m + noise * torch.exp(logs)
        return z * spec_mask[..., None], m, logs


class VITS(nn.Module):
    def __init__(self, cfg: VITSConfig):
        super().__init__()
        self.cfg = c = cfg
        self.text_encoder = TextEncoder(c)
        self.posterior = PosteriorEncoder(c)
        self.flow = ResidualCouplingBlock(c.inter_channels, c.hidden_channels, 5, 1, 4,
                                          gin_channels=c.gin)
        self.decoder = HiFiGANGenerator(c.decoder, gin_channels=c.gin)
        if c.use_sdp:
            self.duration_predictor = StochasticDurationPredictor(c.hidden_channels, 3, 4,
                                                                  c.gin)
        else:
            self.duration_predictor = DurationPredictor(c.hidden_channels, 256, 3, c.gin)
        if c.n_speakers > 1:
            self.speaker_embed = nn.Embedding(c.n_speakers, c.gin_channels)

    def _speaker(self, sid):
        if self.cfg.n_speakers > 1 and sid is not None:
            return self.speaker_embed(sid)[:, None, :]  # (B, 1, G)
        return None

    def train_forward(self, phones, phone_mask, spec, spec_mask, sid=None, *,
                      noise: torch.Tensor | None = None, e_q: torch.Tensor | None = None,
                      segment_start: torch.Tensor | None = None,
                      generator: torch.Generator | None = None) -> dict:
        """The training path → the segment's waveform and the loss pieces
        (the keys of JAX's dict). Draws not given come from ``generator``,
        in the order posterior noise, ``e_q``, segment start."""
        c = self.cfg
        dev = spec.device
        b, t_spec = spec.shape[:2]
        if noise is None:
            noise = torch.randn((b, t_spec, c.inter_channels), generator=generator, device=dev)
        if e_q is None and c.use_sdp:
            e_q = torch.randn((b, phones.shape[1], 2), generator=generator, device=dev)
        g = self._speaker(sid)
        x, m_p, logs_p = self.text_encoder(phones, phone_mask)
        z, m_q, logs_q = self.posterior(spec, spec_mask, g=g, noise=noise)
        z_p, _ = self.flow(z, spec_mask, g=g)

        # MAS over the Gaussian likelihood lattice
        with torch.no_grad():
            s_p_sq_r = torch.exp(-2.0 * logs_p)  # (B, L, C)
            neg_cent1 = torch.sum(-0.5 * math.log(2 * math.pi) - logs_p, dim=-1)
            neg_cent2 = torch.einsum("btc,blc->blt", -0.5 * z_p ** 2, s_p_sq_r)
            neg_cent3 = torch.einsum("btc,blc->blt", z_p, m_p * s_p_sq_r)
            neg_cent4 = torch.sum(-0.5 * m_p ** 2 * s_p_sq_r, dim=-1)
            neg_cent = neg_cent1[:, :, None] + neg_cent2 + neg_cent3 + neg_cent4[:, :, None]
            attn_mask = phone_mask[:, :, None] * spec_mask[:, None, :]
            attn = maximum_path(neg_cent, attn_mask)

        w = torch.sum(attn, dim=-1)  # (B, L) durations
        n_phones = torch.clamp(torch.sum(phone_mask, dim=-1), min=1.0)
        if c.use_sdp:
            l_length = self.duration_predictor(x, phone_mask, w=w, g=g, e_q=e_q) / n_phones
        else:
            logw_hat = self.duration_predictor(x, phone_mask, g=g)
            logw = torch.log(w + 1e-6) * phone_mask
            l_length = torch.sum((logw_hat - logw) ** 2, dim=-1) / n_phones

        m_p_f = torch.einsum("blt,blc->btc", attn, m_p)
        logs_p_f = torch.einsum("blt,blc->btc", attn, logs_p)

        if segment_start is None:
            spec_len = torch.sum(spec_mask, dim=-1).to(torch.int64)
            max_start = torch.clamp(spec_len - c.segment_size, min=0)
            u = torch.rand((b,), generator=generator, device=dev)
            segment_start = (u * (max_start + 1).float()).to(torch.int64)
        z_seg = _slice_segments(z, segment_start, c.segment_size)
        wav_seg = self.decoder(z_seg, g=g)
        return {"wav_segment": wav_seg, "segment_start": segment_start, "z_p": z_p,
                "m_p": m_p_f, "logs_p": logs_p_f, "m_q": m_q, "logs_q": logs_q,
                "attn": attn, "l_length": l_length}

    def infer(self, phones, phone_mask, sid=None, noise_scale: float = 0.667,
              length_scale: float = 1.0, noise_scale_w: float = 0.8,
              max_frames: int = 1000, *, dur_noise: torch.Tensor | None = None,
              z_noise: torch.Tensor | None = None,
              generator: torch.Generator | None = None):
        """Text → (waveform (B, max_frames · hop), frame mask (B, max_frames)
        bool, durations (B, L) int). Draws not given come from
        ``generator``, the duration noise first."""
        c = self.cfg
        dev = phones.device
        b, n = phones.shape
        if dur_noise is None and c.use_sdp:
            dur_noise = torch.randn((b, n, 2), generator=generator, device=dev)
        if z_noise is None:
            z_noise = torch.randn((b, max_frames, c.inter_channels), generator=generator,
                                  device=dev)
        g = self._speaker(sid)
        x, m_p, logs_p = self.text_encoder(phones, phone_mask)
        if c.use_sdp:
            logw = self.duration_predictor(x, phone_mask, g=g, reverse=True,
                                           noise_scale=noise_scale_w, noise=dur_noise)
        else:
            logw = self.duration_predictor(x, phone_mask, g=g)
        w = torch.exp(logw) * phone_mask * length_scale
        w_ceil = torch.ceil(w).to(torch.int32)
        stats_f, frame_mask = length_regulate(torch.cat([m_p, logs_p], dim=-1), w_ceil,
                                              max_frames)
        m_p_f, logs_p_f = stats_f.chunk(2, dim=-1)
        z_p = m_p_f + z_noise * torch.exp(logs_p_f) * noise_scale
        z = self.flow(z_p, frame_mask.float(), g=g, reverse=True)
        wav = self.decoder(z * frame_mask[..., None], g=g)
        return wav, frame_mask, w_ceil

    def voice_conversion(self, spec, spec_mask, sid_src, sid_tgt,
                         noise: torch.Tensor | None = None) -> torch.Tensor:
        """The source's posterior → the flow with the source speaker → its
        reverse with the target speaker → the decoder. ``noise`` None uses
        the posterior mean (deterministic conversion)."""
        g_src, g_tgt = self._speaker(sid_src), self._speaker(sid_tgt)
        z, _, _ = self.posterior(spec, spec_mask, g=g_src, noise=noise)
        z_p, _ = self.flow(z, spec_mask, g=g_src)
        z_hat = self.flow(z_p, spec_mask, g=g_tgt, reverse=True)
        return self.decoder(z_hat * spec_mask[..., None], g=g_tgt)


def _slice_segments(x: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """x (B, T, C), start (B,) → (B, size, C); each start clamped to [0,
    T − size], as ``lax.dynamic_slice`` clamps it."""
    start = start.to(torch.int64).clamp(0, x.shape[1] - size)
    idx = start[:, None] + torch.arange(size, device=x.device)[None, :]
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def slice_audio_segments(audio: torch.Tensor, start_frames: torch.Tensor, size_frames: int,
                         hop: int) -> torch.Tensor:
    """The waveform segments (B, size_frames · hop) under `_slice_segments`'
    latent crops."""
    n = size_frames * hop
    start = (start_frames.to(torch.int64) * hop).clamp(0, audio.shape[1] - n)
    idx = start[:, None] + torch.arange(n, device=audio.device)[None, :]
    return torch.gather(audio, 1, idx)


def vits_kl_loss(z_p, logs_q, m_p, logs_p, mask) -> torch.Tensor:
    """KL(q‖p) over the aligned frames, per frame and channel."""
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * (torch.exp(2.0 * logs_q) + (z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    kl = torch.sum(kl * mask[..., None])
    return kl / torch.clamp(torch.sum(mask) * z_p.shape[-1], min=1.0)
