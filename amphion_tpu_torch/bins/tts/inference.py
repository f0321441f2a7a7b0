"""MaskGCT pipeline assembly from checkpoints (port of
`build_maskgct_pipeline` in `bins/tts/inference.py`, which `bins/serve.py`
builds its default backend with; the inference CLI's modes are not ported).

Weights are the port's checkpoints (`runtime/checkpoint.py`: a directory
with one ``state.pt`` whose ``"model"`` is a state dict):

- T2S and S2A from ``log_dir/<exp_name>/checkpoint`` (the latest
  checkpoint there), one state dict whose keys start ``t2s.`` and ``s2a.``;
- or ``--weights_dir``: a ``manifest.json`` naming a checkpoint directory
  for ``t2s`` and for ``s2a_full``, ``s2a_1layer`` or ``s2a`` (the first
  found), and optionally ``semantic_codec`` and ``acoustic_codec``, each
  the state dict of that module alone;
- the semantic codec from ``--semantic_ckpt``, the acoustic codec from
  ``--codec_ckpt``, else random weights (a warning), drawn as Flax
  initializes them (`utils/convert.init_like_flax`) from a generator
  seeded with ``crc32`` of the module's name.

The S2A's conditioning follows its checkpoint's keys: token conditioning
where it holds ``cond_emb``, the semantic codec's decoded latents where it
holds ``sem_proj``. The semantic extractor is the mel front end
(``preprocess.semantic_source`` ``"mel"`` in `egs/tts/MaskGCT/exp_config.json`):
log-mel (kernel 3 on the card) of the hop-truncated prompt. Orbax
checkpoints of the JAX package raise.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path

import torch

from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec, CodecConfig
from amphion_tpu_torch.models.codec.repcodec import RepCodec, RepCodecConfig
from amphion_tpu_torch.models.tts.maskgct.maskgct import S2AConfig, T2SConfig
from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram
from amphion_tpu_torch.pipelines.maskgct_pipeline import MaskGCTPipeline
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.text.g2p import G2PModule
from amphion_tpu_torch.text.symbol_table import SymbolTable
from amphion_tpu_torch.utils.convert import init_like_flax
from amphion_tpu_torch.utils.device import resolve_device


def _model_state(ckpt_dir) -> tuple[dict, int, int]:
    state, epoch, step = CheckpointManager(ckpt_dir).restore_raw(map_location="cpu")
    return state["model"], epoch, step


def _split(state: dict, prefix: str) -> dict:
    sub = {k[len(prefix) + 1:]: v for k, v in state.items() if k.startswith(prefix + ".")}
    if not sub:
        raise KeyError(f"the checkpoint holds no {prefix}.* weights")
    return sub


def _random_state(module: torch.nn.Module, name: str, device, logger, flag: str) -> dict:
    logger.warning(f"no {flag}: RANDOM {name} weights (smoke only)")
    module.to(device)
    init_like_flax(module, torch.Generator(device).manual_seed(zlib.crc32(name.encode())))
    return module.state_dict()


def build_maskgct_pipeline(args, cfg: dict, logger, device=None,
                           compute_dtype: str = "bfloat16") -> MaskGCTPipeline:
    """The MaskGCT pipeline on ``device`` (``cuda`` unless named), T2S and
    S2A in ``compute_dtype``."""
    device = resolve_device(device)
    p = cfg["preprocess"]
    mel_cfg = MelConfig.from_preprocess_cfg(p)
    symbols = SymbolTable.from_file(Path(p["processed_dir"]) / cfg["dataset"][0]
                                    / p["symbols_dict"])
    g2p = G2PModule(p.get("g2p_backend", "char"), p.get("lexicon_path") or None)

    states = {}
    weights_dir = getattr(args, "weights_dir", None)
    manifest = {}
    if weights_dir:
        manifest = json.loads((Path(weights_dir) / "manifest.json").read_text())
        logger.info(f"loading weights from the manifest: {sorted(manifest)}")

        def from_manifest(*names):
            for n in names:
                if n in manifest:
                    return _model_state(manifest[n])[0]
            raise KeyError(f"none of {names} in {weights_dir}/manifest.json")

        states["t2s"] = from_manifest("t2s")
        states["s2a"] = from_manifest("s2a_full", "s2a_1layer", "s2a")
    else:
        exp_dir = Path(cfg.get("log_dir", "ckpts")) / args.exp_name
        state, epoch, step = _model_state(exp_dir / "checkpoint")
        states["t2s"], states["s2a"] = _split(state, "t2s"), _split(state, "s2a")
        logger.info(f"MaskGCT restored from epoch {epoch} step {step}")

    model = cfg.get("model", {})
    mt, ms = model.get("t2s") or {}, model.get("s2a") or {}
    msem, mc = model.get("semantic_codec") or {}, model.get("codec") or {}
    sem_cfg = RepCodecConfig(
        feature_dim=p["n_mel"], hidden=msem.get("hidden", 384),
        codebook_size=msem.get("codebook_size", 8192),
        codebook_dim=msem.get("codebook_dim", 8), num_blocks=msem.get("num_blocks", 4))
    ac_cfg = CodecConfig(
        sample_rate=p["sample_rate"], strides=tuple(mc.get("strides", (2, 4, 5, 6))),
        num_quantizers=mc.get("num_quantizers", 8), codebook_size=mc.get("codebook_size", 1024),
        codebook_dim=mc.get("codebook_dim", 8), encoder_dim=mc.get("encoder_dim", 32),
        latent_dim=mc.get("latent_dim", 256), decoder_dim=mc.get("decoder_dim", 32))

    for name, flag, ckpt, make in (
            ("semantic_codec", "--semantic_ckpt", getattr(args, "semantic_ckpt", None),
             lambda: RepCodec(sem_cfg, with_decode=True)),
            ("acoustic_codec", "--codec_ckpt", getattr(args, "codec_ckpt", None),
             lambda: AmphionCodec(ac_cfg))):
        if name in manifest:
            states[name] = _model_state(manifest[name])[0]
        elif ckpt:
            states[name] = _model_state(ckpt)[0]
        else:
            states[name] = _random_state(make(), name, device, logger, flag)

    hop = mel_cfg.hop_size

    def semantic_extractor(audio: torch.Tensor) -> torch.Tensor:
        t = max(len(audio) // hop * hop, hop)
        return mel_spectrogram(audio[:t][None], mel_cfg).transpose(1, 2)[0]

    return MaskGCTPipeline.build(
        T2SConfig(hidden=mt.get("hidden", 1024), num_layers=mt.get("num_layers", 16),
                  num_heads=mt.get("num_heads", 16),
                  codebook_size=mt.get("codebook_size", 8192),
                  phone_vocab=max(len(symbols) + 1, 64)),
        S2AConfig(hidden=ms.get("hidden", 1024), num_layers=ms.get("num_layers", 16),
                  num_heads=ms.get("num_heads", 16),
                  codebook_size=ms.get("codebook_size", 1024),
                  num_quantizers=ac_cfg.num_quantizers,
                  # the mel-proxy S2A conditions on the semantic codec's latents
                  semantic_dim=sem_cfg.hidden),
        sem_cfg, ac_cfg, states, device, compute_dtype,
        semantic_extractor=semantic_extractor, g2p=g2p, symbol_table=symbols,
        sample_rate=p["sample_rate"], semantic_rate=p["sample_rate"] // hop)
