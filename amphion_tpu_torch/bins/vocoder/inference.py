"""Vocoder inference CLI (port of `bins/vocoder/inference.py`): copy
synthesis, audio → log-mel → generator → wav files, one file per forward
at batch 1, in the modes ``from_audio``, ``from_feature`` and
``from_dataset``.

    python -m amphion_tpu_torch.bins.vocoder.inference \\
        --config egs/vocoder/gan/bigvgan/exp_config.json \\
        --checkpoint_path <dir> --output_dir <dir> --mode from_audio \\
        --audio_dir <dir> [--device cuda|cpu]

Every generator of `runtime/vocoder_trainer.build_generator` that takes a
mel alone runs: HiFi-GAN, BigVGAN, MelGAN, APNet and Vocos. NSF-HiFiGAN
also needs an F0 contour, which this CLI does not feed (nor does JAX's),
so it raises. The log-mel is kernel 3 on the card
(`ops/mel.mel_spectrogram`); BigVGAN's activations run kernel 2 when the
config sets ``use_pallas_act``. Float32 is strict on the card
(`utils/device.strict_float32`). The checkpoint is the port's own
(`runtime/vocoder_trainer.save_generator` writes one); an Orbax directory
of the JAX package raises. The port adds ``--device`` (default ``cuda``;
raises without a card).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from amphion_tpu_torch.data.audio_io import load_wav, save_wav
from amphion_tpu_torch.data.metadata import load_metadata
from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram
from amphion_tpu_torch.runtime.vocoder_trainer import restore_generator
from amphion_tpu_torch.utils.config import load_config
from amphion_tpu_torch.utils.device import resolve_device, strict_float32
from amphion_tpu_torch.utils.logging import get_logger


@torch.no_grad()
def synthesize_mel(generator, mel: np.ndarray | torch.Tensor, device) -> np.ndarray:
    """(N, n_mel) mel → waveform (N·hop,) float32."""
    mel = torch.as_tensor(mel, dtype=torch.float32, device=device)
    return generator(mel[None])[0].cpu().numpy()


@torch.no_grad()
def synthesize_file(generator, wav_path, mel_cfg: MelConfig, out_path, device) -> int:
    """Copy-synthesise one wav file into ``out_path``; returns its samples."""
    x, _ = load_wav(wav_path, sr=mel_cfg.sample_rate)
    t = max(len(x) // mel_cfg.hop_size * mel_cfg.hop_size, mel_cfg.hop_size)
    y = torch.from_numpy(np.ascontiguousarray(x[:t])).to(device)
    mel = mel_spectrogram(y[None], mel_cfg)[0].transpose(0, 1)  # (N, n_mel)
    wav = synthesize_mel(generator, mel, device)
    save_wav(out_path, wav, mel_cfg.sample_rate)
    return len(wav)


def main(argv: list[str] | None = None) -> list[dict]:
    """Parse ``argv`` (the command line by default) and synthesise; returns
    one record per written file: its path, samples and wall seconds (the
    host clock around reading, the mel, the generator and writing)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--exp_name", default="exp")
    parser.add_argument("--checkpoint_path", default="")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--mode", default="from_dataset",
                        choices=["from_dataset", "from_audio", "from_feature"])
    parser.add_argument("--audio_dir", default="")
    parser.add_argument("--feature_dir", default="",
                        help="dir of per-uid mel .npy (n_mel, N) or (N, n_mel)"
                             " for --mode from_feature")
    parser.add_argument("--infer_testing_set", default="test")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; raises without a card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    strict_float32()
    cfg = load_config(args.config)
    if cfg["model"]["generator"] == "nsf_hifigan":
        raise NotImplementedError(
            "nsf_hifigan takes an F0 contour beside the mel, and copy synthesis feeds the "
            "generator a mel alone (JAX's bins/vocoder/inference.py cannot run it either); "
            "NSF-HiFiGAN runs through bins/vocoder/train.py")
    logger = get_logger("vocoder_infer")
    mel_cfg = MelConfig.from_preprocess_cfg(cfg["preprocess"])
    # the generator's weights from the {"g": ...} training checkpoint
    ckpt_dir = (Path(args.checkpoint_path) if args.checkpoint_path
                else Path(cfg.get("log_dir", "ckpts")) / args.exp_name / "checkpoint")
    generator, _, epoch, step = restore_generator(cfg, ckpt_dir, mel_cfg.n_mel, device)
    logger.info(f"restored generator from epoch {epoch} step {step} on {device}")

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    records = []

    def timed(target: Path, fn) -> None:
        t0 = time.perf_counter()
        n = fn()
        records.append({"path": str(target), "samples": n,
                        "seconds": time.perf_counter() - t0})
        logger.info(f"wrote {target}")

    if args.mode == "from_audio":
        for w in sorted(Path(args.audio_dir).glob("*.wav")):
            timed(out / w.name,
                  lambda w=w: synthesize_file(generator, w, mel_cfg, out / w.name, device))
    elif args.mode == "from_feature":
        if not args.feature_dir:
            raise ValueError("--feature_dir is required for --mode from_feature")
        for f in sorted(Path(args.feature_dir).glob("*.npy")):
            def run(f=f):
                mel = np.load(f).astype(np.float32)
                if mel.shape[0] == mel_cfg.n_mel:  # (n_mel, N) → (N, n_mel)
                    mel = mel.T
                wav = synthesize_mel(generator, mel, device)
                save_wav(out / f"{f.stem}.wav", wav, mel_cfg.sample_rate)
                return len(wav)
            timed(out / f"{f.stem}.wav", run)
    else:
        for ds in cfg["dataset"]:
            meta = Path(cfg["preprocess"]["processed_dir"]) / ds / f"{args.infer_testing_set}.json"
            for u in load_metadata(meta):
                target = out / f"{u.uid}.wav"
                timed(target, lambda u=u, target=target: synthesize_file(
                    generator, u.path, mel_cfg, target, device))
        logger.info(f"synthesized test sets into {out}")
    return records


if __name__ == "__main__":
    main()
