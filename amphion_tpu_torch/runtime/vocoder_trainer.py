"""GAN vocoder wiring (port of `amphion_tpu/runtime/vocoder_trainer.py`,
without the DiffWave trainer): the generator factory keyed on
``cfg["model"]["generator"]`` (hifigan, bigvgan, melgan, apnet, vocos,
nsf_hifigan), `GANVocoderTrainer`, a loader for a trained generator, and a
writer of the checkpoint layout it reads.

The port's vocoder checkpoint is a checkpoint directory (`runtime/checkpoint`
naming) holding ``state.pt`` with ``{"g": {"model": state_dict, "step": n,
...}, "d": {...}, "epoch": n, ...}``: the trainer's two states, of which
inference reads the generator's weights (`save_generator` writes that half
alone).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from amphion_tpu_torch.data.dataset import Prefetcher, SegmentAudioDataset
from amphion_tpu_torch.data.metadata import load_metadata
from amphion_tpu_torch.models.vocoders.apnet import APNetConfig, APNetGenerator
from amphion_tpu_torch.models.vocoders.bigvgan import BigVGANConfig, BigVGANGenerator
from amphion_tpu_torch.models.vocoders.gan_trainer import (
    CombinedDiscriminator,
    GANTrainConfig,
    create_gan_states,
    make_gan_train_step,
)
from amphion_tpu_torch.models.vocoders.hifigan import HiFiGANConfig, HiFiGANGenerator
from amphion_tpu_torch.models.vocoders.melgan import MelGANConfig, MelGANGenerator
from amphion_tpu_torch.models.vocoders.nsf_hifigan import (
    NSFHiFiGANConfig,
    NSFHiFiGANGenerator,
)
from amphion_tpu_torch.models.vocoders.vocos import VocosConfig, VocosGenerator
from amphion_tpu_torch.ops.f0 import F0Config, yin_f0
from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.runtime.loop import LoopConfig, TrainLoop
from amphion_tpu_torch.runtime.train_state import TrainStates
from amphion_tpu_torch.utils.config import load_config, save_config
from amphion_tpu_torch.utils.convert import init_like_flax
from amphion_tpu_torch.utils.device import resolve_device, strict_float32
from amphion_tpu_torch.utils.logging import get_logger, model_summary


def build_generator(cfg: dict, n_mel: int):
    """(generator module, hop size) for ``cfg["model"]["generator"]``, with
    JAX's defaults where the model block is missing."""
    name = cfg["model"]["generator"]
    m = cfg["model"].get(name)
    if name == "hifigan":
        gcfg = HiFiGANConfig.from_model_cfg(m, n_mel) if m else HiFiGANConfig(n_mel=n_mel)
        return HiFiGANGenerator(gcfg), gcfg.hop_size
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
    if name == "melgan":
        gcfg = MelGANConfig(n_mel=n_mel, **(
            dict(upsample_rates=tuple(m["upsample_rates"])) if m else {}))
        return MelGANGenerator(gcfg), gcfg.hop_size
    if name == "apnet":
        gcfg = APNetConfig(n_mel=n_mel, **(
            dict(n_fft=m["n_fft"], hop_size=m["hop_size"],
                 win_size=m.get("win_size", m["n_fft"])) if m else {}))
        return APNetGenerator(gcfg), gcfg.hop_size
    if name == "vocos":
        gcfg = VocosConfig(n_mel=n_mel, **(
            dict(n_fft=m["n_fft"], hop_size=m["hop_size"]) if m else {}))
        return VocosGenerator(gcfg), gcfg.hop_size
    if name == "nsf_hifigan":
        base = (HiFiGANConfig.from_model_cfg(m["base"], n_mel)
                if m and m.get("base") else HiFiGANConfig(n_mel=n_mel))
        gcfg = NSFHiFiGANConfig(base=base, sample_rate=cfg["preprocess"]["sample_rate"],
                                num_harmonics=m.get("num_harmonics", 7) if m else 7)
        return NSFHiFiGANGenerator(gcfg), base.hop_size
    raise ValueError(f"unknown generator {name!r}")


def build_discriminator(cfg: dict) -> CombinedDiscriminator:
    """`CombinedDiscriminator` of ``cfg["model"]["discriminators"]`` (MPD +
    MSD by default), with JAX's defaults."""
    m = cfg["model"]
    return CombinedDiscriminator(
        use=tuple(m.get("discriminators", ["mpd", "msd"])),
        mpd_periods=tuple(m.get("mpd_periods", (2, 3, 5, 7, 11))),
        msd_scales=m.get("msd_scales", 3),
        channel_mult=m.get("discriminator_channel_mult_factor", 1.0),
        sample_rate=cfg["preprocess"]["sample_rate"])


def step_flops(cfg: dict) -> dict:
    """Floating-point operations of one `GANVocoderTrainer` step at
    ``cfg``'s batch and segment, from shapes alone: the generator and the
    discriminators are built on the meta device (no memory, no arithmetic)
    and run forward once under `FlopCounterMode`, which counts convolutions
    and matrix products. A step of `make_gan_train_step` is 4 generator
    forward units (two forwards, a backward of two) and 9 discriminator ones
    (the D step's two forwards and their backwards, two units each; the G
    step's two forwards and one input backward). Not for BigVGAN, whose
    kernel wrapper takes no meta tensor."""
    from torch.utils.flop_counter import FlopCounterMode

    p, t = cfg["preprocess"], cfg["train"]
    b, n = t["batch_size"], t.get("segment_frames", 64)
    with torch.device("meta"):
        gen, hop = build_generator(cfg, p["n_mel"])
        disc = build_discriminator(cfg)
        mel = torch.empty(b, n, p["n_mel"])
        inputs = (mel, torch.empty(b, n)) if cfg["model"]["generator"] == "nsf_hifigan" else (mel,)
        counts = []
        for fn, args in ((gen, inputs), (disc, (torch.empty(b, n * hop),))):
            with FlopCounterMode(display=False) as counter, torch.no_grad():
                fn(*args)
            counts.append(counter.get_total_flops())
    g, d = counts
    return {"generator_forward": g, "discriminator_forward": d, "step": 4 * g + 9 * d,
            "params_g": sum(x.numel() for x in gen.parameters()),
            "params_d": sum(x.numel() for x in disc.parameters())}


class GANVocoderTrainer:
    """`bins/vocoder/train.py`'s GANVocoder (and Vocos) trainer: the
    generator of ``cfg["model"]["generator"]`` against
    `CombinedDiscriminator` (``model.discriminators``, MPD + MSD by
    default), one D-then-G step a batch (`make_gan_train_step`), each half
    with its own optimizer. Float32 is strict on the card
    (`utils/device.strict_float32`).

    Batches are random segments of ``train.segment_frames`` frames from the
    ``train.json`` of each dataset under ``preprocess.processed_dir``, with
    their log-mel made on the device (kernel 3 on the card) as the
    generator's input (B, N, n_mel); NSF-HiFiGAN also takes their YIN F0
    (`ops/f0.yin_f0`, on the device, cut to the mel's frames) and a draw of
    its excitation noise a step from the G state's generator. A clip longer
    than a segment is cropped at an offset drawn from (``train.seed``,
    epoch, batch), so a resume repeats the uninterrupted run's batches. Both models are drawn
    from ``train.seed`` with the Flax initializers (`init_like_flax`). The
    resolved config is written as ``exp_config.json`` beside the
    checkpoints, where `load_vocoder` finds it."""

    def __init__(self, args, cfg: dict):
        self.cfg = cfg
        self.logger = get_logger("vocoder")
        self.logger.setLevel(str(getattr(args, "log_level", "info")).upper())
        self.device = resolve_device(getattr(args, "device", None))
        strict_float32()
        p, t, m = cfg["preprocess"], cfg["train"], cfg["model"]
        self.train_cfg = GANTrainConfig(
            lr=t["adamw"]["lr"], adam_b1=t["adamw"]["adam_b1"], adam_b2=t["adamw"]["adam_b2"],
            lr_decay=t["exponential_lr"]["lr_decay"],
            compute_dtype=t.get("compute_dtype", "float32"))
        self.mel_cfg = MelConfig.from_preprocess_cfg(p)
        self.is_nsf = m["generator"] == "nsf_hifigan"
        self.f0_cfg = F0Config.from_preprocess_cfg(p) if self.is_nsf else None
        step = make_gan_train_step(self.mel_cfg, self.train_cfg,
                                   gen_args=("mel", "f0") if self.is_nsf else ("mel",),
                                   use_rng=self.is_nsf)
        generator, hop = build_generator(cfg, p["n_mel"])
        if hop != p["hop_size"]:
            raise ValueError(f"generator hop {hop} != preprocess hop {p['hop_size']}")
        discriminator = build_discriminator(cfg)

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
        batch = {"mel": mel_spectrogram(au, self.mel_cfg).transpose(1, 2), "audio": au}
        if self.is_nsf:
            f0, _ = yin_f0(au, self.f0_cfg)
            batch["f0"] = f0[:, : batch["mel"].shape[1]]
        return batch

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
