"""GAN vocoder training (port of `amphion_tpu/models/vocoders/gan_trainer.py`):
the combined discriminator, the optimizer and the D-then-G step.

`make_gan_train_step` returns ``train_step(gstate, dstate, batch) ->
(gstate, dstate, metrics)``, which computes what JAX's jitted step does, in
its order, eagerly:

1. the generator's forward on ``batch[k] for k in gen_args`` without
   gradient;
2. the LSGAN D loss on D(real) and D(fake), its gradient and the D update;
3. a second generator forward with gradient, scored by the *updated*
   discriminator: adversarial + feature-matching + mel loss;
4. the G gradient (``torch.autograd.grad`` over G's parameters only, so the
   backward computes no gradient of D's weights) and the G update.

With ``use_rng`` (NSF-HiFiGAN's excitation noise) the step draws once from
the G state's generator (the generator module's ``draw``) and feeds the
same draws to both generator forwards, as JAX splits its key once a step.
With BigVGAN's ``use_pallas_act`` each generator forward runs kernel 2 73
times at the egs config (the second through `AASnakeBetaFn`); the mel
loss runs kernel 3 twice, the fake's through `LogMelFn`. Only float32 is
ported: JAX's ``compute_dtype`` casting raises (ROADMAP.md A5).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from amphion_tpu_torch.models.vocoders.discriminators import (
    MRD_RESOLUTIONS,
    MultiPeriodDiscriminator,
    MultiResolutionDiscriminator,
    MultiScaleDiscriminator,
    MultiScaleSubBandCQTDiscriminator,
    MultiSTFTDiscriminator,
)
from amphion_tpu_torch.models.vocoders.losses import (
    discriminator_loss,
    feature_loss,
    generator_adv_loss,
    mel_loss,
)
from amphion_tpu_torch.ops.mel import MelConfig
from amphion_tpu_torch.runtime.optimizers import ClipAdamW
from amphion_tpu_torch.runtime.train_state import TrainState


class CombinedDiscriminator(nn.Module):
    """The configured discriminators (``use`` ⊆ mpd, msd, mrd, msstft,
    mssbcqt) as one module: logits and feature maps concatenated in JAX's
    order (MPD, MSD, MRD, MS-STFT, MS-SB-CQT). MRD takes no channel
    multiplier, as in JAX's; MS-SB-CQT takes ``sample_rate``."""

    def __init__(self, use: tuple[str, ...] = ("mpd", "msd"),
                 mpd_periods: tuple[int, ...] = (2, 3, 5, 7, 11), msd_scales: int = 3,
                 channel_mult: float = 1.0,
                 mrd_resolutions: tuple[tuple[int, int, int], ...] = MRD_RESOLUTIONS,
                 sample_rate: int = 24000):
        super().__init__()
        unknown = [u for u in use if u not in ("mpd", "msd", "mrd", "msstft", "mssbcqt")]
        if unknown:
            raise ValueError(f"unknown discriminators {unknown}")
        self.subs = []
        if "mpd" in use:
            self.MultiPeriodDiscriminator_0 = MultiPeriodDiscriminator(mpd_periods, channel_mult)
            self.subs.append(self.MultiPeriodDiscriminator_0)
        if "msd" in use:
            self.MultiScaleDiscriminator_0 = MultiScaleDiscriminator(msd_scales, channel_mult)
            self.subs.append(self.MultiScaleDiscriminator_0)
        if "mrd" in use:
            self.MultiResolutionDiscriminator_0 = MultiResolutionDiscriminator(mrd_resolutions)
            self.subs.append(self.MultiResolutionDiscriminator_0)
        if "msstft" in use:
            self.MultiSTFTDiscriminator_0 = MultiSTFTDiscriminator()
            self.subs.append(self.MultiSTFTDiscriminator_0)
        if "mssbcqt" in use:
            self.MultiScaleSubBandCQTDiscriminator_0 = MultiScaleSubBandCQTDiscriminator(
                sample_rate)
            self.subs.append(self.MultiScaleSubBandCQTDiscriminator_0)

    def forward(self, x: torch.Tensor):
        logits, fmaps = [], []
        for d in self.subs:
            lo, fm = d(x)
            logits += lo
            fmaps += fm
        return logits, fmaps


@dataclass(frozen=True)
class GANTrainConfig:
    lr: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999
    decay_steps: int = 1000  # updates per application of lr_decay (continuous)
    mel_loss_weight: float = 45.0
    grad_clip: float | None = None
    compute_dtype: str = "float32"  # only float32 is ported


def make_optimizer(params, cfg: GANTrainConfig) -> ClipAdamW:
    """optax's ``adamw(exponential_decay(lr, decay_steps, lr_decay), b1,
    b2)``, after ``clip_by_global_norm(grad_clip)`` when that is set."""
    return ClipAdamW(params, cfg.lr, max_norm=cfg.grad_clip, betas=(cfg.adam_b1, cfg.adam_b2),
                     decay_rate=cfg.lr_decay, decay_steps=cfg.decay_steps)


def create_gan_states(generator: nn.Module, discriminator: nn.Module,
                      cfg: GANTrainConfig = GANTrainConfig(),
                      seed: int = 0) -> tuple[TrainState, TrainState]:
    """The G and D train states around the modules as they are (draw them
    first, e.g. with `utils/convert.init_like_flax`), each with its own
    optimizer and update count."""
    states = []
    for i, m in enumerate((generator, discriminator)):
        dev = next(m.parameters()).device
        states.append(TrainState(0, m, make_optimizer(m.parameters(), cfg),
                                 torch.Generator(dev).manual_seed(seed + i)))
    return states[0], states[1]


def make_gan_train_step(mel_cfg: MelConfig, train_cfg: GANTrainConfig = GANTrainConfig(),
                        gen_args: tuple[str, ...] = ("mel",), use_rng: bool = False):
    """``train_step(gstate, dstate, batch) -> (gstate, dstate, metrics)``;
    ``batch``: ``{"audio": (B, N·hop)}`` and the generator's inputs
    ``gen_args`` (``"mel"`` (B, N, n_mel); NSF-HiFiGAN adds ``"f0"`` (B,
    N)); metrics d_loss, g_loss, g_adv, g_fm, g_mel as 0-d tensors."""
    if train_cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype {train_cfg.compute_dtype!r}: only float32 GAN training is "
            "ported to amphion_tpu_torch (ROADMAP.md A5)")

    def train_step(gstate: TrainState, dstate: TrainState, batch: dict):
        audio = batch["audio"]
        inputs = tuple(batch[k] for k in gen_args)
        gen, disc = gstate.model, dstate.model
        draws = gen.draw(*inputs, generator=gstate.generator) if use_rng else {}

        # the discriminator's update, the generator frozen
        with torch.no_grad():
            fake = gen(*inputs, **draws)
        logits_r, _ = disc(audio)
        logits_f, _ = disc(fake)
        d_loss, _, _ = discriminator_loss(logits_r, logits_f)
        dstate.apply_gradients(list(torch.autograd.grad(d_loss, dstate.optimizer.params)))

        # the generator's update, scored by the updated discriminator
        fake_g = gen(*inputs, **draws)
        with torch.no_grad():
            _, fmaps_r = disc(audio)
        logits_f, fmaps_f = disc(fake_g)
        adv = generator_adv_loss(logits_f)
        fm = feature_loss(fmaps_r, fmaps_f)
        ml = mel_loss(audio, fake_g, mel_cfg, train_cfg.mel_loss_weight)
        total = adv + fm + ml
        gstate.apply_gradients(list(torch.autograd.grad(total, gstate.optimizer.params)))
        metrics = {"d_loss": d_loss, "g_loss": total, "g_adv": adv, "g_fm": fm, "g_mel": ml}
        return gstate, dstate, {k: v.detach() for k, v in metrics.items()}

    return train_step
