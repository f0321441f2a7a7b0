"""TTS training CLI (port of `bins/tts/train.py`): the trainer registry
keyed on ``cfg["model_type"]``.

    python -m amphion_tpu_torch.bins.tts.train --config egs/tts/VALLE/exp_config.json \\
        --exp_name valle [--resume [--resume_type resume|finetune] \\
        [--resume_from_ckpt_path DIR]] [--device cpu]

``VITS``, ``VALLE``, ``FastSpeech2`` and ``MaskGCT`` train with
`runtime/tts_trainer` on what `bins/tts/preprocess.py` wrote (phones; for
VALL-E and MaskGCT codes, for MaskGCT semantic tokens and latents) and,
for FastSpeech2, the MFA TextGrids under ``<processed>/<ds>/textgrids``;
their checkpoints under ``log_dir/<exp_name>/checkpoint`` are what
`bins/tts/inference.py` reads. Jets and NaturalSpeech2 (ROADMAP A6.4),
Metis and DualCodecTTS (ROADMAP A6.6) are not ported and raise. ``--test`` and
``--log_level`` are accepted and unused, as in JAX. Float32 is strict on
the card (`utils/device.strict_float32`). The port adds ``--device``
(default ``cuda``; raises without a card).
"""

from __future__ import annotations

import argparse

from amphion_tpu_torch.runtime.tts_trainer import TRAINERS
from amphion_tpu_torch.utils.config import load_config
from amphion_tpu_torch.utils.device import strict_float32

NOT_PORTED = {"Jets": "A6.4", "NaturalSpeech2": "A6.4", "Metis": "A6.6",
              "DualCodecTTS": "A6.6"}


def build_trainer(args, cfg: dict):
    model_type = cfg.get("model_type")
    if model_type in NOT_PORTED:
        raise NotImplementedError(f"the {model_type} trainer is not ported to "
                                  f"amphion_tpu_torch yet (ROADMAP A6: {NOT_PORTED[model_type]})")
    if model_type not in TRAINERS:
        raise NotImplementedError(
            f"model_type {model_type!r} is not in the trainer registry; available: "
            f"{sorted(TRAINERS)}")
    return TRAINERS[model_type](args, cfg)


def main(argv: list[str] | None = None):
    """Parse ``argv`` (the command line by default), train, and return the
    trainer."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--exp_name", default="exp")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--resume_type", default="resume", choices=["resume", "finetune"])
    parser.add_argument("--resume_from_ckpt_path", default="")
    parser.add_argument("--log_level", default="info")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; raises without a card)")
    args = parser.parse_args(argv)
    strict_float32()
    trainer = build_trainer(args, load_config(args.config))
    trainer.train_loop()
    return trainer


if __name__ == "__main__":
    main()
