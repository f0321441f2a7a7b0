"""Vocoder training CLI (port of `bins/vocoder/train.py`): the trainer
registry keyed on ``cfg["model_type"]``.

    python -m amphion_tpu_torch.bins.vocoder.train \\
        --config egs/vocoder/gan/bigvgan/exp_config.json --exp_name bigvgan \\
        [--resume [--resume_type resume|finetune] [--resume_from_ckpt_path DIR]] \\
        [--device cpu]

``GANVocoder`` trains the configured generator (HiFi-GAN, BigVGAN, MelGAN,
APNet, Vocos or NSF-HiFiGAN) against the configured discriminators (MPD,
MSD, MRD, MS-STFT, MS-SB-CQT) with `runtime/vocoder_trainer.
GANVocoderTrainer`; ``Vocos`` is the same trainer, as in JAX. Its
checkpoints under ``log_dir/<exp_name>/checkpoint`` are read by
`bins/vocoder/inference.py`. ``DiffusionVocoder`` (DiffWave) is not ported
and raises. Float32 is strict on the card (`utils/device.strict_float32`).
The port adds ``--device`` (default ``cuda``; raises without a card) and
reads ``train.metrics_path`` (a JSONL file of per-step losses and wall
times).
"""

from __future__ import annotations

import argparse

from amphion_tpu_torch.runtime.vocoder_trainer import GANVocoderTrainer
from amphion_tpu_torch.utils.config import load_config
from amphion_tpu_torch.utils.device import strict_float32

TRAINERS = {"GANVocoder": GANVocoderTrainer, "Vocos": GANVocoderTrainer}


def build_trainer(args, cfg: dict):
    model_type = cfg["model_type"]
    if model_type == "DiffusionVocoder":
        raise NotImplementedError("model_type 'DiffusionVocoder' (DiffWave) is not ported to "
                                  "amphion_tpu_torch yet (ROADMAP.md A5)")
    if model_type not in TRAINERS:
        raise ValueError(f"model_type {model_type!r} not in {sorted(TRAINERS)}")
    return TRAINERS[model_type](args, cfg)


def main(argv: list[str] | None = None):
    """Parse ``argv`` (the command line by default), train, and return the
    trainer."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--exp_name", default="exp")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--resume_type", default="resume", choices=["resume", "finetune"])
    parser.add_argument("--resume_from_ckpt_path", default="")
    parser.add_argument("--log_level", default="info")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; raises without a card)")
    args = parser.parse_args(argv)
    strict_float32()
    trainer = build_trainer(args, load_config(args.config))
    trainer.train_loop()
    return trainer


if __name__ == "__main__":
    main()
