"""GAN vocoder wiring (port of `amphion_tpu/runtime/vocoder_trainer.py`,
without the NSF branch and the DiffWave trainer): the generator factory
keyed on ``cfg["model"]["generator"]``, `GANVocoderTrainer`, a loader for
a trained generator, and a writer of the checkpoint layout it reads.

The port's vocoder checkpoint is a checkpoint directory (`runtime/checkpoint`
naming) holding ``state.pt`` with ``{"g": {"model": state_dict, "step": n,
...}, "d": {...}, "epoch": n, ...}``: the trainer's two states, of which
inference reads the generator's weights (`save_generator` writes that half
alone). Only BigVGAN is ported; the other generators raise.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from amphion_tpu_torch.data.dataset import Prefetcher, SegmentAudioDataset
from amphion_tpu_torch.data.metadata import load_metadata
from amphion_tpu_torch.models.vocoders.bigvgan import BigVGANConfig, BigVGANGenerator
from amphion_tpu_torch.models.vocoders.gan_trainer import (
    CombinedDiscriminator,
    GANTrainConfig,
    create_gan_states,
    make_gan_train_step,
)
from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.runtime.loop import LoopConfig, TrainLoop
from amphion_tpu_torch.runtime.train_state import TrainStates
from amphion_tpu_torch.utils.config import load_config, save_config
from amphion_tpu_torch.utils.convert import init_like_flax
from amphion_tpu_torch.utils.device import resolve_device
from amphion_tpu_torch.utils.logging import get_logger, model_summary


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


class GANVocoderTrainer:
    """`bins/vocoder/train.py`'s GANVocoder trainer: the generator of
    ``cfg["model"]["generator"]`` against `CombinedDiscriminator`
    (``model.discriminators``, MPD + MSD by default), one D-then-G step a
    batch (`make_gan_train_step`), each half with its own optimizer.

    Batches are random segments of ``train.segment_frames`` frames from the
    ``train.json`` of each dataset under ``preprocess.processed_dir``, with
    their log-mel made on the device (kernel 3 on the card) as the
    generator's input (B, N, n_mel). A clip longer than a segment is
    cropped at an offset drawn from (``train.seed``, epoch, batch), so a
    resume repeats the uninterrupted run's batches. Both models are drawn
    from ``train.seed`` with the Flax initializers (`init_like_flax`). The
    resolved config is written as ``exp_config.json`` beside the
    checkpoints, where `load_vocoder` finds it."""

    def __init__(self, args, cfg: dict):
        self.cfg = cfg
        self.logger = get_logger("vocoder")
        self.logger.setLevel(str(getattr(args, "log_level", "info")).upper())
        self.device = resolve_device(getattr(args, "device", None))
        p, t, m = cfg["preprocess"], cfg["train"], cfg["model"]
        self.train_cfg = GANTrainConfig(
            lr=t["adamw"]["lr"], adam_b1=t["adamw"]["adam_b1"], adam_b2=t["adamw"]["adam_b2"],
            lr_decay=t["exponential_lr"]["lr_decay"],
            compute_dtype=t.get("compute_dtype", "float32"))
        self.mel_cfg = MelConfig.from_preprocess_cfg(p)
        step = make_gan_train_step(self.mel_cfg, self.train_cfg)
        generator, hop = build_generator(cfg, p["n_mel"])
        if hop != p["hop_size"]:
            raise ValueError(f"generator hop {hop} != preprocess hop {p['hop_size']}")
        discriminator = CombinedDiscriminator(
            use=tuple(m.get("discriminators", ["mpd", "msd"])),
            mpd_periods=tuple(m.get("mpd_periods", (2, 3, 5, 7, 11))),
            msd_scales=m.get("msd_scales", 3),
            channel_mult=m.get("discriminator_channel_mult_factor", 1.0))

        utts = []
        for ds in cfg["dataset"]:
            utts.extend(load_metadata(Path(p["processed_dir"]) / ds / "train.json"))
        self.dataset = SegmentAudioDataset(utts, p["sample_rate"],
                                           t.get("segment_frames", 64) * hop)
        self.batch_size = t["batch_size"]

        self.seed = t.get("seed", 0)
        for i, module in enumerate((generator, discriminator)):
            init_like_flax(module.to(self.device),
                           torch.Generator(self.device).manual_seed(self.seed + i))
        model_summary({"generator": generator, "discriminator": discriminator}, self.logger)
        g, d = create_gan_states(generator, discriminator, self.train_cfg, self.seed + 2)
        states = TrainStates(g=g, d=d)

        def train_step(states: TrainStates, batch: dict):
            states["g"], states["d"], metrics = step(states["g"], states["d"], batch)
            return states, metrics

        exp_dir = Path(cfg.get("log_dir", "ckpts")) / args.exp_name
        self.ckpt = CheckpointManager(exp_dir / "checkpoint",
                                      list(t.get("save_checkpoint_stride", [1])),
                                      list(t.get("keep_last", [-1])))
        save_config(exp_dir / "exp_config.json", cfg)
        self.loop = TrainLoop(
            LoopConfig(max_epoch=t.get("max_epoch", -1), max_steps=t.get("max_steps", -1),
                       log_interval=t.get("log_interval", 100),
                       save_checkpoints_steps=t.get("save_checkpoints_steps", 0),
                       metrics_path=t.get("metrics_path", "")),
            train_step, states, self._data, ckpt=self.ckpt, logger=self.logger)
        if getattr(args, "resume", False):
            self.loop.resume(getattr(args, "resume_from_ckpt_path", "") or None,
                             getattr(args, "resume_type", "resume"))

    def _make_batch(self, indices: list[int], rng: np.random.Generator) -> dict:
        audio = np.stack([self.dataset.segment(i, rng)["audio"] for i in indices])
        au = torch.from_numpy(audio).to(self.device)
        return {"mel": mel_spectrogram(au, self.mel_cfg).transpose(1, 2), "audio": au}

    def _data(self, skip: int = 0):
        """This epoch's full batches, in the epoch's own permutation, from the
        ``skip``-th on."""
        n, bs, epoch = len(self.dataset), self.batch_size, self.loop.epoch
        order = np.random.default_rng(epoch).permutation(n)
        starts = list(range(0, n - bs + 1, bs))

        def gen():
            with torch.no_grad():
                for j in range(skip, len(starts)):
                    rng = np.random.default_rng([self.seed, epoch, j])
                    yield self._make_batch(order[starts[j]: starts[j] + bs].tolist(), rng)

        return Prefetcher(gen)

    def train_loop(self):
        return self.loop.run()


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
