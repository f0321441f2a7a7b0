"""GAN vocoder wiring (the port of the parts of
`amphion_tpu/runtime/vocoder_trainer.py` that inference needs): the
generator factory keyed on ``cfg["model"]["generator"]``, a loader for a
trained generator, and a writer of the checkpoint layout it reads.

The port's vocoder checkpoint is a checkpoint directory (`runtime/checkpoint`
naming) holding ``state.pt`` with ``{"g": {"model": state_dict, "step": n},
"epoch": n}``, the generator half of the ``{"g", "d"}`` state a GAN trainer
keeps. Only BigVGAN is ported; the other generators raise.
"""

from __future__ import annotations

from pathlib import Path

import torch

from amphion_tpu_torch.models.vocoders.bigvgan import BigVGANConfig, BigVGANGenerator
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.utils.config import load_config
from amphion_tpu_torch.utils.device import resolve_device


def build_generator(cfg: dict, n_mel: int):
    """(generator module, hop size) for ``cfg["model"]["generator"]``."""
    name = cfg["model"]["generator"]
    m = cfg["model"].get(name)
    if name == "bigvgan":
        kw = dict(
            upsample_rates=tuple(m["upsample_rates"]),
            upsample_kernel_sizes=tuple(m["upsample_kernel_sizes"]),
            upsample_initial_channel=m["upsample_initial_channel"],
            resblock_kernel_sizes=tuple(m["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(tuple(d) for d in m["resblock_dilation_sizes"]),
        ) if m else {}
        if m and "use_pallas_act" in m:
            kw["use_pallas_act"] = bool(m["use_pallas_act"])
        gcfg = BigVGANConfig(n_mel=n_mel, **kw)
        return BigVGANGenerator(gcfg), gcfg.hop_size
    raise NotImplementedError(
        f"generator {name!r} is not ported to amphion_tpu_torch yet (ROADMAP.md, "
        "queue A); bigvgan is")


class _GeneratorState:
    """What `CheckpointManager.save` writes for a lone generator."""

    def __init__(self, module: torch.nn.Module, step: int):
        self.module, self.step = module, step

    def state_dict(self) -> dict:
        return {"g": {"model": self.module.state_dict(), "step": self.step}}


def save_generator(directory: str | Path, module: torch.nn.Module, epoch: int = 0,
                   step: int = 0) -> str:
    """Write ``module``'s weights as a vocoder checkpoint under
    ``directory``; returns the checkpoint's own directory."""
    return CheckpointManager(directory).save(_GeneratorState(module, step), epoch, step, 0.0)


def restore_generator(cfg: dict, checkpoint: str | Path, n_mel: int, device: torch.device):
    """The generator ``cfg`` names, with the weights of the checkpoint at
    ``checkpoint`` (a checkpoint directory, or a directory of them: the
    latest), on ``device`` in eval mode → (generator, hop, epoch, step)."""
    gen, hop = build_generator(cfg, n_mel)
    state, epoch, step = CheckpointManager(checkpoint).restore_raw(map_location=device)
    if "g" not in state:
        raise KeyError(
            f"{checkpoint} is not a vocoder checkpoint: its state.pt has no 'g' entry "
            f"(keys {sorted(state)}); save_generator writes {{'g': {{'model': ...}}}}")
    gen.load_state_dict(state["g"]["model"])
    return gen.to(device).eval(), hop, epoch, step


def load_vocoder(vocoder_ckpt: str | Path, n_mel: int, vocoder_config: str = "",
                 fallback_cfg: dict | None = None, device=None):
    """Build and restore a GAN vocoder generator from a checkpoint directory.

    Config resolution order:
      1. an explicit ``vocoder_config`` path,
      2. ``exp_config.json`` next to the checkpoint directory or in one of
         its two parents,
      3. ``fallback_cfg`` if it carries ``model.generator``.

    Returns ``(apply_fn, hop)`` where ``apply_fn(mel (B, T, n_mel)) ->
    audio (B, T·hop)`` runs without gradients on ``device`` (cuda unless
    named)."""
    dev = resolve_device(device)
    ckpt_dir = Path(vocoder_ckpt)
    cfg = None
    if vocoder_config:
        cfg = load_config(vocoder_config)
    else:
        for base in (ckpt_dir, ckpt_dir.parent, ckpt_dir.parent.parent):
            snap = base / "exp_config.json"
            if snap.is_file():
                cfg = load_config(snap)
                break
    if cfg is None and fallback_cfg is not None and "generator" in fallback_cfg.get("model", {}):
        cfg = fallback_cfg
    if cfg is None:
        raise ValueError(
            f"cannot resolve the vocoder architecture for {vocoder_ckpt}: pass "
            "vocoder_config, or keep exp_config.json beside the checkpoints")
    gen, hop, _, _ = restore_generator(cfg, ckpt_dir, n_mel, dev)

    @torch.no_grad()
    def apply_fn(mel: torch.Tensor) -> torch.Tensor:
        return gen(mel.to(dev))

    return apply_fn, hop
