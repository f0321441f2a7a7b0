"""VITS training (port of `amphion_tpu/models/tts/vits/vits_trainer.py`):
the G and D train states and the D-then-G step with the VAE, flow,
duration and adversarial criteria.

`make_vits_train_step` returns ``train_step(gstate, dstate, batch,
draws=None) -> (gstate, dstate, metrics)``, which computes what JAX's
jitted step does, eagerly:

1. `VITS.train_forward` with the step's draws (posterior noise, the
   duration posterior's ``e_q``, segment starts), taken once a step from
   the G state's generator (or ``draws``), as JAX splits one key a step and
   feeds it to both of its forwards;
2. the LSGAN D loss on D(real segment) and D(generated segment, detached),
   its gradient and the D update;
3. the G loss scored by the *updated* discriminator, D(real) under
   ``no_grad``: adversarial + feature matching + mel L1 (× the config's
   weight; kernel 3 on the card, the generated segment's through `LogMelFn`)
   + ``kl_weight`` × KL + ``dur_weight`` × the duration NLL;
4. G's gradient by ``torch.autograd.grad`` over G's parameters, and the G
   update.

JAX runs the generator's forward twice with the same parameters and key
(once for D's input, once under the G loss); the two are equal, so the
port runs it once, with gradient, and gives D its detached waveform: one
alignment search and one forward a step fewer, the same numbers.
"""

from __future__ import annotations

import torch

from amphion_tpu_torch.models.tts.vits.vits import VITS, slice_audio_segments, vits_kl_loss
from amphion_tpu_torch.models.vocoders.gan_trainer import GANTrainConfig, create_gan_states
from amphion_tpu_torch.models.vocoders.losses import (
    discriminator_loss,
    feature_loss,
    generator_adv_loss,
    mel_loss,
)
from amphion_tpu_torch.ops.mel import MelConfig
from amphion_tpu_torch.runtime.train_state import TrainState


def create_vits_states(model: VITS, discriminator: torch.nn.Module,
                       train_cfg: GANTrainConfig = GANTrainConfig(),
                       seed: int = 0) -> tuple[TrainState, TrainState]:
    """The G and D states around the modules as they are (draw them first,
    e.g. with `utils/convert.init_like_flax`): each with the decayed AdamW
    of `gan_trainer.make_optimizer` and a generator seeded ``seed`` (G) and
    ``seed + 1`` (D)."""
    return create_gan_states(model, discriminator, train_cfg, seed)


def vits_draws(model: VITS, batch: dict, generator: torch.Generator) -> dict:
    """One step's draws from ``generator``: the posterior noise (B, T,
    inter), ``e_q`` (B, L, 2) and the segment starts (B,)."""
    c = model.cfg
    spec, mask = batch["spec"], batch["spec_mask"]
    b, t = spec.shape[:2]
    dev = spec.device
    noise = torch.randn((b, t, c.inter_channels), generator=generator, device=dev)
    e_q = torch.randn((b, batch["phones"].shape[1], 2), generator=generator, device=dev)
    max_start = torch.clamp(mask.sum(-1).to(torch.int64) - c.segment_size, min=0)
    u = torch.rand((b,), generator=generator, device=dev)
    return {"noise": noise, "e_q": e_q,
            "segment_start": (u * (max_start + 1).float()).to(torch.int64)}


def make_vits_train_step(mel_cfg: MelConfig, train_cfg: GANTrainConfig = GANTrainConfig(),
                         kl_weight: float = 1.0, dur_weight: float = 1.0):
    """``train_step(gstate, dstate, batch, draws=None)``; ``batch``: phones
    (B, L), phone_mask (B, L), spec (B, T, F), spec_mask (B, T), audio (B,
    T · hop) and sid (B,); metrics d_loss, g_loss, g_adv, g_fm, g_mel, g_kl,
    g_dur as 0-d tensors."""
    if train_cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype {train_cfg.compute_dtype!r}: only float32 VITS training is "
            "ported to amphion_tpu_torch (ROADMAP.md A5)")

    def train_step(gstate: TrainState, dstate: TrainState, batch: dict,
                   draws: dict | None = None):
        model, disc = gstate.model, dstate.model
        hop, seg = model.cfg.decoder.hop_size, model.cfg.segment_size
        draws = draws or vits_draws(model, batch, gstate.generator)
        out = model.train_forward(batch["phones"], batch["phone_mask"], batch["spec"],
                                  batch["spec_mask"], batch.get("sid"), **draws)
        real = slice_audio_segments(batch["audio"], out["segment_start"], seg, hop)
        fake = out["wav_segment"]

        # the discriminator's update, the generated segment detached
        logits_r, _ = disc(real)
        logits_f, _ = disc(fake.detach())
        d_loss, _, _ = discriminator_loss(logits_r, logits_f)
        dstate.apply_gradients(list(torch.autograd.grad(d_loss, dstate.optimizer.params)))

        # the generator's update, scored by the updated discriminator
        with torch.no_grad():
            _, fmaps_r = disc(real)
        logits_f, fmaps_f = disc(fake)
        adv = generator_adv_loss(logits_f)
        fm = feature_loss(fmaps_r, fmaps_f)
        ml = mel_loss(real, fake, mel_cfg, train_cfg.mel_loss_weight)
        kl = kl_weight * vits_kl_loss(out["z_p"], out["logs_q"], out["m_p"], out["logs_p"],
                                      batch["spec_mask"])
        dur = dur_weight * torch.mean(out["l_length"])
        total = adv + fm + ml + kl + dur
        grads = torch.autograd.grad(total, gstate.optimizer.params, allow_unused=True)
        gstate.apply_gradients([torch.zeros_like(p) if g is None else g
                                for p, g in zip(gstate.optimizer.params, grads)])
        metrics = {"d_loss": d_loss, "g_loss": total, "g_adv": adv, "g_fm": fm, "g_mel": ml,
                   "g_kl": kl, "g_dur": dur}
        return gstate, dstate, {k: v.detach() for k, v in metrics.items()}

    return train_step
