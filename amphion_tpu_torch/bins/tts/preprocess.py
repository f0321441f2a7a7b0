"""TTS preprocessing CLI (port of `bins/tts/preprocess.py`): corpus adapter
→ acoustic features → phone sequences → codec codes → semantic tokens,
with JAX's switches.

    python -m amphion_tpu_torch.bins.tts.preprocess --config <exp config> \\
        [--extract_codes [--codec_ckpt DIR]] \\
        [--extract_semantic [--semantic_ckpt DIR]] [--device cuda]

For each ``dataset`` of the config, ``dataset_path[ds]`` goes through its
adapter (`data/preprocessors`) into ``preprocess.processed_dir/<ds>``:

- ``extract_mel`` (default on): `data/processors/acoustic`, kernel 3 on
  the card, F0 with ``extract_pitch``, energy with ``extract_energy``;
- ``extract_phone`` (default on; `config/base.json` sets it off, so a TTS
  recipe sets it on): `data/processors/phone`, ``phones/<uid>.json`` and
  ``symbols.dict``;
- ``--extract_codes``: `extract_codes`, ``codes/<uid>.npy`` (Q, N) int32;
- ``--extract_semantic``: `extract_semantic`, ``semantic/<uid>.npy`` (N,)
  int32 and ``semantic_feats/<uid>.npy`` (N, hidden) float32.

Checkpoints (``--codec_ckpt``, ``--semantic_ckpt``) are port checkpoint
directories whose ``"model"`` is the module's state dict, read as
`bins/tts/inference` reads them; without one, random weights are drawn as
Flax initializes them from a generator seeded 0, with a warning. The EnCodec
codec (``model.codec.type`` ``"encodec"``, ROADMAP A6.5) and semantic
sources other than the mel (``preprocess.semantic_source``, ROADMAP A6.2)
are not ported and raise. ``--num_workers`` is accepted and unused, as in
JAX. The port adds ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from amphion_tpu_torch.bins.tts.inference import _codec_config, _model_state, _random_state
from amphion_tpu_torch.data.audio_io import load_wav
from amphion_tpu_torch.data.preprocessors import preprocess_dataset
from amphion_tpu_torch.data.processors.acoustic import extract_acoustic_features
from amphion_tpu_torch.data.processors.phone import extract_phone_sequences
from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec
from amphion_tpu_torch.models.codec.repcodec import RepCodec, RepCodecConfig
from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram
from amphion_tpu_torch.utils.config import load_config
from amphion_tpu_torch.utils.device import resolve_device, strict_float32
from amphion_tpu_torch.utils.logging import get_logger
from amphion_tpu_torch.utils.tokenizer import AudioTokenizer


def _load_or_draw(module: torch.nn.Module, name: str, ckpt: str, flag: str, device, logger):
    """``module`` on ``device`` with the weights of ``ckpt``, or random ones
    drawn from a generator seeded 0 (JAX draws from ``jax.random.key(0)``)."""
    if ckpt:
        state, epoch, step = _model_state(ckpt)
        module.load_state_dict(state)
        logger.info(f"{name} restored from epoch {epoch} step {step}")
        module.to(device)
    else:
        _random_state(module, name, device, logger, flag, seed=0)
    return module.eval().requires_grad_(False)


def _padded(x: np.ndarray, hop: int) -> tuple[np.ndarray, int]:
    """``x`` cut to whole hops (one at least) and zero-padded to a multiple
    of 64 hops (JAX's buckets: few shapes) → (padded, frames)."""
    t = max(len(x) // hop * hop, hop)
    bucket = hop * 64
    padded = np.zeros(((t + bucket - 1) // bucket) * bucket, np.float32)
    padded[:t] = x[:t]
    return padded, t // hop


def extract_codes(utts, out_dir, cfg: dict, codec_ckpt: str, logger, device=None,
                  codec: AmphionCodec | None = None) -> None:
    """Tokenize utterances with the Amphion codec → ``codes/<uid>.npy``
    (Q, N) int32, the VALL-E and S2A targets. ``codec`` (a module, e.g.
    carried over from Flax) takes the place of the checkpoint."""
    device = resolve_device(device)
    m = cfg.get("model", {}).get("codec") or {}
    if m.get("type", "") == "encodec":
        raise NotImplementedError("the EnCodec tokenizer (model.codec.type 'encodec') is "
                                  "not ported (ROADMAP A6.5)")
    if codec is None:
        codec = _load_or_draw(AmphionCodec(_codec_config(cfg)), "codec", codec_ckpt,
                              "--codec_ckpt", device, logger)
    tok = AudioTokenizer(codec.to(device).eval(), cfg["preprocess"]["sample_rate"])
    code_dir = Path(out_dir) / "codes"
    code_dir.mkdir(parents=True, exist_ok=True)
    for u in utts:
        x, _ = load_wav(u.path, sr=tok.sample_rate)
        padded, n = _padded(x, tok.hop)
        codes = tok.encode(padded)[0][:, :n]  # (Q, N)
        np.save(code_dir / f"{u.uid}.npy", codes.cpu().numpy().astype(np.int32))


def semantic_codec_config(cfg: dict) -> RepCodecConfig:
    """The semantic RepCodec over the mel (``model.semantic_codec``, JAX's
    defaults where absent)."""
    m = cfg.get("model", {}).get("semantic_codec") or {}
    return RepCodecConfig(feature_dim=cfg["preprocess"]["n_mel"], hidden=m.get("hidden", 384),
                          codebook_size=m.get("codebook_size", 8192),
                          codebook_dim=m.get("codebook_dim", 8),
                          num_blocks=m.get("num_blocks", 4))


@torch.inference_mode()
def extract_semantic(utts, out_dir, cfg: dict, semantic_ckpt: str, logger, device=None,
                     codec: RepCodec | None = None) -> None:
    """Semantic tokens for MaskGCT: the log-mel (kernel 3 on the card) of the
    padded clip → RepCodec tokens, cut to the clip's frames →
    ``semantic/<uid>.npy``, and their decoded latents →
    ``semantic_feats/<uid>.npy`` (the S2A's conditioning). ``codec`` (a
    RepCodec built ``with_decode``) takes the place of the checkpoint."""
    device = resolve_device(device)
    p = cfg["preprocess"]
    source = p.get("semantic_source", "mel")
    if source != "mel":
        raise NotImplementedError(f"semantic_source {source!r} is not ported (ROADMAP "
                                  "A6.2); the port extracts from the mel")
    if codec is None:
        codec = _load_or_draw(RepCodec(semantic_codec_config(cfg), with_decode=True),
                              "semantic codec", semantic_ckpt, "--semantic_ckpt", device,
                              logger)
    codec = codec.to(device).eval()
    mel_cfg = MelConfig.from_preprocess_cfg(p)
    tok_dir, lat_dir = Path(out_dir) / "semantic", Path(out_dir) / "semantic_feats"
    tok_dir.mkdir(parents=True, exist_ok=True)
    lat_dir.mkdir(parents=True, exist_ok=True)
    for u in utts:
        x, _ = load_wav(u.path, sr=p["sample_rate"])
        padded, n = _padded(x, mel_cfg.hop_size)
        feats = mel_spectrogram(torch.from_numpy(padded).to(device)[None], mel_cfg)
        tokens = codec.encode(feats.transpose(1, 2))[:, :n]
        latents = codec.decode_tokens(tokens)
        np.save(tok_dir / f"{u.uid}.npy", tokens[0].cpu().numpy().astype(np.int32))
        np.save(lat_dir / f"{u.uid}.npy", latents[0].float().cpu().numpy())


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--num_workers", type=int, default=1)
    parser.add_argument("--extract_codes", action="store_true",
                        help="tokenize audio with a codec ckpt (VALL-E)")
    parser.add_argument("--codec_ckpt", default="",
                        help="checkpoint dir of a trained AmphionCodec")
    parser.add_argument("--extract_semantic", action="store_true",
                        help="semantic tokens via RepCodec (MaskGCT)")
    parser.add_argument("--semantic_ckpt", default="",
                        help="checkpoint dir of a trained RepCodec")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    strict_float32()
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    logger = get_logger("preprocess")
    p = cfg["preprocess"]
    for ds in cfg["dataset"]:
        logger.info(f"preprocessing {ds}")
        train, test = preprocess_dataset(ds, cfg["dataset_path"][ds], p["processed_dir"])
        out = f"{p['processed_dir']}/{ds}"
        if p.get("extract_mel", True):
            extract_acoustic_features(train + test, out, MelConfig.from_preprocess_cfg(p),
                                      extract_f0=p.get("extract_pitch", False),
                                      extract_energy=p.get("extract_energy", False),
                                      device=device)
        if p.get("extract_phone", True):
            extract_phone_sequences(train + test, out, backend=p.get("g2p_backend", "char"),
                                    lexicon_path=p.get("lexicon_path") or None)
        if args.extract_codes:
            extract_codes(train + test, out, cfg, args.codec_ckpt, logger, device)
        if args.extract_semantic:
            extract_semantic(train + test, out, cfg, args.semantic_ckpt, logger, device)
        logger.info(f"  done: {len(train)} train / {len(test)} test")


if __name__ == "__main__":
    main()
