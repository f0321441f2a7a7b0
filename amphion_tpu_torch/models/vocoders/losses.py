"""GAN vocoder criteria (port of `amphion_tpu/models/vocoders/losses.py`):
LSGAN adversarial losses, feature matching and the mel reconstruction
loss, over lists of logits and feature maps."""

from __future__ import annotations

import torch

from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram


def feature_loss(fmaps_real, fmaps_fake) -> torch.Tensor:
    """2 × the sum of mean |r − f| over every feature map (HiFi-GAN)."""
    loss = 0.0
    for fmr, fmf in zip(fmaps_real, fmaps_fake):
        for r, f in zip(fmr, fmf):
            loss = loss + torch.mean(torch.abs(r - f))
    return 2.0 * loss


def discriminator_loss(logits_real, logits_fake) -> tuple[torch.Tensor, list, list]:
    """LSGAN D loss: Σ mean((1 − D(x))²) + mean(D(G(z))²) over the
    sub-discriminators → (loss, real terms, fake terms)."""
    loss = 0.0
    r_losses, f_losses = [], []
    for dr, df in zip(logits_real, logits_fake):
        r = torch.mean((1.0 - dr) ** 2)
        f = torch.mean(df ** 2)
        loss = loss + r + f
        r_losses.append(r)
        f_losses.append(f)
    return loss, r_losses, f_losses


def generator_adv_loss(logits_fake) -> torch.Tensor:
    """LSGAN G loss: Σ mean((1 − D(G(z)))²) over the sub-discriminators."""
    loss = 0.0
    for df in logits_fake:
        loss = loss + torch.mean((1.0 - df) ** 2)
    return loss


def mel_loss(audio_real: torch.Tensor, audio_fake: torch.Tensor, cfg: MelConfig,
             weight: float = 45.0) -> torch.Tensor:
    """``weight`` × mean |log-mel(real) − log-mel(fake)|. The fake's mel is
    differentiable (kernel 3 forward on the card, `LogMelFn`)."""
    mel_r = mel_spectrogram(audio_real, cfg)
    mel_f = mel_spectrogram(audio_fake, cfg)
    return weight * torch.mean(torch.abs(mel_r - mel_f))
