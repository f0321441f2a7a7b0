"""Vevo pipeline assembly from trainer checkpoints (port of
`build_pipeline` in `bins/vc/inference.py`; the inference CLI's tasks are
not ported).

The FM, and the AR when ``--ar_exp`` names it, are restored from
``log_dir/<exp>/checkpoint``, where the port's trainer writes
(`amphion_tpu_torch/bins/vc/train.py`). The tokenizers take
``--content_ckpt``/``--style_ckpt`` checkpoints of the same format, or random
weights drawn from ``crc32(name)`` with a warning, as the trainer draws
them, so that a served pipeline tokenizes as its models were trained. The
vocoder takes ``--vocoder_ckpt``, or torch's default initialisation under
seed 0 (``has_vocoder`` is then False and the caller warns). Orbax
checkpoints, converted-pretrained bundles (``--weights_dir``) and HuBERT
features are not readable here and raise.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import torch

from amphion_tpu_torch.pipelines.vevo_pipeline import (
    VevoPipeline,
    assemble_pipeline,
    vevo_modules,
)
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.utils.convert import init_like_flax
from amphion_tpu_torch.utils.device import resolve_device, strict_float32


def _restore(module: torch.nn.Module, ckpt_dir, logger, tag: str) -> None:
    state, _, step = CheckpointManager(ckpt_dir).restore_raw(map_location="cpu")
    module.load_state_dict(state["model"])
    logger.info(f"{tag} restored from step {step} ({ckpt_dir})")


def build_pipeline(args, cfg: dict, logger, device=None,
                   compute_dtype: str = "bfloat16") -> tuple[VevoPipeline, bool]:
    """The Vevo-Voice pipeline (``ar`` None without ``--ar_exp``) on
    ``device`` (``cuda`` unless named), its FM and AR prepared for
    ``compute_dtype`` → (pipeline, has_vocoder)."""
    if getattr(args, "weights_dir", ""):
        raise NotImplementedError("--weights_dir bundles hold Flax/Orbax trees, which the "
                                  "port cannot read; restore port checkpoints instead")
    if getattr(args, "hubert", False):
        raise NotImplementedError("HuBERT features are not ported: the pipeline "
                                  "tokenizes the mel front end")
    if not getattr(args, "fm_exp", ""):
        raise SystemExit("--fm_exp is required")
    device = resolve_device(device)
    strict_float32()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        mods = vevo_modules(cfg, voice=True)
    for name in ("content_tokenizer", "style_tokenizer"):
        ckpt = getattr(args, name.split("_")[0] + "_ckpt", "")
        if ckpt:
            _restore(mods[name], ckpt, logger, name)
        else:  # drawn on the device, as the trainer draws them
            logger.warning(f"no checkpoint for {name}: RANDOM weights (smoke)")
            init_like_flax(mods[name].to(device), torch.Generator(device).manual_seed(
                zlib.crc32(name.encode())))
    log_dir = Path(cfg.get("log_dir", "ckpts"))
    _restore(mods["fm"], log_dir / args.fm_exp / "checkpoint", logger, "fm")
    if getattr(args, "ar_exp", ""):
        _restore(mods["ar"], log_dir / args.ar_exp / "checkpoint", logger, "ar")
    else:
        mods["ar"] = None
    has_vocoder = bool(getattr(args, "vocoder_ckpt", ""))
    if has_vocoder:
        _restore(mods["vocoder"], args.vocoder_ckpt, logger, "vocos")
    return assemble_pipeline(cfg, mods, device, compute_dtype), has_vocoder
