"""TTS inference CLI (port of `bins/tts/inference.py`): VITS and
FastSpeech2 from text, zero-shot VALL-E and MaskGCT from text and a prompt
recording, one request → a wav file.

    python -m amphion_tpu_torch.bins.tts.inference --config <exp config> \
        --exp_name <exp> --text "..." --output_path out.wav \
        [--speaker NAME] [--noise_scale 0.667] [--length_scale 1.0] \
        [--max_frames 1000] [--vocoder_ckpt DIR [--vocoder_config FILE]] \
        [--prompt_audio prompt.wav --prompt_text "..."] [--codec_ckpt DIR] \
        [--semantic_ckpt DIR] [--weights_dir DIR] [--max_new 512] \
        [--top_k 50] [--device cuda]

``model_type`` in the config picks the mode:

- ``VITS``, and any type no other mode takes, as in JAX (`vits_inference`):
  the g2p ids of ``text`` in the dataset's ``symbols.dict``, blanks
  interspersed where ``preprocess.add_blank`` (default on), the speaker of
  ``spk2id.json`` (beside the checkpoints) named by ``--speaker`` (the
  first where unknown) when there are several, then `VITS.infer` with
  ``--noise_scale``, ``--length_scale``, the duration noise scale 0.8 and
  ``--max_frames``, its draws from a generator seeded 0; the waveform is
  cut to the frame mask. Weights: the ``"g"`` state of the latest
  checkpoint under ``log_dir/<exp_name>/checkpoint``.
- ``FastSpeech2`` (`fastspeech2_inference`): the g2p ids of ``text`` in
  the trainer's ``<exp>/symbols.dict``, predicted durations scaled by
  ``--length_scale``, pitch and energy, the Postnet mel cut to the frame
  mask, then `_vocode`: the GAN vocoder of ``--vocoder_ckpt``
  (`runtime/vocoder_trainer.load_vocoder`, kernel-free HiFi-GAN or any
  generator it builds) or else Griffin-Lim (`ops/dsp.mel_to_audio`, 32
  iterations, its initial phase drawn from a generator seeded 0), which
  gives (frames − 1) · hop samples where a vocoder gives frames · hop.

- ``VALLE`` (`valle_inference`): g2p of ``prompt_text + " " + text``, the
  hop-truncated prompt's codec codes (`utils/tokenizer.AudioTokenizer`),
  the AR's sampled continuation of codebook 0 (`valle.ar_generate` in bf16,
  top-k, temperature 1, a generator seeded 0), the greedy NAR with the
  prompt's codes as its prefix (float32) and the codec decode of the
  generated frames, as JAX runs them. VALL-E's weights are the port
  checkpoint at ``log_dir/<exp_name>/checkpoint`` (a ``state.pt`` whose
  ``"model"`` is the state dict), the codec's ``--codec_ckpt`` or random
  weights (a warning) drawn by `utils/convert.init_like_flax` from a
  generator seeded 0.
- ``MaskGCT`` (`maskgct_zeroshot_inference`): `MaskGCTPipeline.__call__`
  (T2S and S2A in bf16 on a batch of one, seed 0) over `build_maskgct_pipeline`,
  which `bins/serve.py`'s default backend builds too. Weights:

  - T2S and S2A from ``log_dir/<exp_name>/checkpoint`` (the latest
    checkpoint there), one state dict whose keys start ``t2s.`` and
    ``s2a.``;
  - or ``--weights_dir``: a ``manifest.json`` naming a checkpoint directory
    for ``t2s`` and for ``s2a_full``, ``s2a_1layer`` or ``s2a`` (the first
    found), and optionally ``semantic_codec`` and ``acoustic_codec``, each
    the state dict of that module alone;
  - the semantic codec from ``--semantic_ckpt``, the acoustic codec from
    ``--codec_ckpt``, else random weights (a warning), drawn as Flax
    initializes them (`utils/convert.init_like_flax`) from a generator
    seeded with ``crc32`` of the module's name.

  The S2A's conditioning follows its checkpoint's keys: token conditioning
  where it holds ``cond_emb``, the semantic codec's decoded latents where
  it holds ``sem_proj``. The semantic extractor is the mel front end
  (``preprocess.semantic_source`` ``"mel"`` in
  `egs/tts/MaskGCT/exp_config.json`): log-mel (kernel 3 on the card) of
  the hop-truncated prompt.

``--testing_set`` runs every utterance of a processed split (its text and
speaker), as in JAX. Jets and NaturalSpeech2 (ROADMAP A6.4) and
``--num_steps`` are not ported; their configs raise. The port adds
``--device`` (default ``cuda``). Orbax checkpoints of the JAX package
raise.
"""

from __future__ import annotations

import argparse
import copy
import json
import zlib
from pathlib import Path

import torch

from amphion_tpu_torch.data.audio_io import load_wav, save_wav

from amphion_tpu_torch.models.codec.amphion_codec import AmphionCodec, CodecConfig
from amphion_tpu_torch.models.codec.repcodec import RepCodec, RepCodecConfig
from amphion_tpu_torch.models.tts.fastspeech2.fs2 import FastSpeech2
from amphion_tpu_torch.models.tts.maskgct.maskgct import S2AConfig, T2SConfig
from amphion_tpu_torch.models.tts.valle.valle import (
    VALLE,
    VALLEConfig,
    ar_generate,
    prepare_for_decode,
)
from amphion_tpu_torch.models.tts.vits.vits import VITS
from amphion_tpu_torch.ops.dsp import mel_to_audio
from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram
from amphion_tpu_torch.pipelines.maskgct_pipeline import MaskGCTPipeline
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.runtime.tts_trainer import fs2_config, vits_config
from amphion_tpu_torch.runtime.vocoder_trainer import load_vocoder
from amphion_tpu_torch.text.g2p import G2PModule, intersperse
from amphion_tpu_torch.text.symbol_table import SymbolTable
from amphion_tpu_torch.utils.config import load_config
from amphion_tpu_torch.utils.convert import init_like_flax
from amphion_tpu_torch.utils.device import resolve_device, strict_float32
from amphion_tpu_torch.utils.logging import get_logger
from amphion_tpu_torch.utils.tokenizer import AudioTokenizer


def _model_state(ckpt_dir) -> tuple[dict, int, int]:
    state, epoch, step = CheckpointManager(ckpt_dir).restore_raw(map_location="cpu")
    return state["model"], epoch, step


def _split(state: dict, prefix: str) -> dict:
    sub = {k[len(prefix) + 1:]: v for k, v in state.items() if k.startswith(prefix + ".")}
    if not sub:
        raise KeyError(f"the checkpoint holds no {prefix}.* weights")
    return sub


def _random_state(module: torch.nn.Module, name: str, device, logger, flag: str,
                  seed: int | None = None) -> dict:
    """``module``'s weights drawn on ``device`` as Flax draws them, from a
    generator seeded ``seed`` (default ``crc32`` of ``name``)."""
    logger.warning(f"no {flag}: RANDOM {name} weights (smoke only)")
    module.to(device)
    seed = zlib.crc32(name.encode()) if seed is None else seed
    init_like_flax(module, torch.Generator(device).manual_seed(seed))
    return module.state_dict()


def _codec_config(cfg: dict) -> CodecConfig:
    """The Amphion codec of ``model.codec`` (its defaults where absent)."""
    mc = cfg.get("model", {}).get("codec") or {}
    return CodecConfig(
        sample_rate=cfg["preprocess"]["sample_rate"],
        strides=tuple(mc.get("strides", (2, 4, 5, 6))),
        num_quantizers=mc.get("num_quantizers", 8), codebook_size=mc.get("codebook_size", 1024),
        codebook_dim=mc.get("codebook_dim", 8), encoder_dim=mc.get("encoder_dim", 32),
        latent_dim=mc.get("latent_dim", 256), decoder_dim=mc.get("decoder_dim", 32))


def _symbols(cfg: dict) -> tuple[SymbolTable, G2PModule]:
    p = cfg["preprocess"]
    symbols = SymbolTable.from_file(Path(p["processed_dir"]) / cfg["dataset"][0]
                                    / p["symbols_dict"])
    return symbols, G2PModule(p.get("g2p_backend", "char"), p.get("lexicon_path") or None)


def build_valle(args, cfg: dict, logger, device=None):
    """VALL-E in float32 and its tokenizer on ``device`` (``cuda`` unless
    named), the assembly `bins/serve.py`'s valle backend and `valle_inference`
    share → (model, tokenizer, g2p, symbols)."""
    device = resolve_device(device)
    symbols, g2p = _symbols(cfg)
    codec = AmphionCodec(_codec_config(cfg))
    if getattr(args, "codec_ckpt", None):
        codec.load_state_dict(_model_state(args.codec_ckpt)[0])
    else:  # seed 0, as JAX draws the codec without a checkpoint
        _random_state(codec, "codec", device, logger, "--codec_ckpt", seed=0)
    tok = AudioTokenizer(codec.to(device).eval().requires_grad_(False),
                         cfg["preprocess"]["sample_rate"])
    m = cfg.get("model", {}).get("valle") or {}
    model = VALLE(VALLEConfig(
        num_phones=max(len(symbols) + 1, 64), audio_vocab=m.get("audio_vocab", 1024),
        num_quantizers=m.get("num_quantizers", 8), hidden=m.get("hidden", 1024),
        num_layers=m.get("num_layers", 12), num_heads=m.get("num_heads", 16),
        max_position=m.get("max_position", 4096)))
    exp_dir = Path(cfg.get("log_dir", "ckpts")) / args.exp_name
    state, epoch, step = _model_state(exp_dir / "checkpoint")
    model.load_state_dict(state)
    logger.info(f"VALL-E restored from epoch {epoch} step {step}")
    return model.to(device).eval().requires_grad_(False), tok, g2p, symbols


def build_maskgct_pipeline(args, cfg: dict, logger, device=None,
                           compute_dtype: str = "bfloat16") -> MaskGCTPipeline:
    """The MaskGCT pipeline on ``device`` (``cuda`` unless named), T2S and
    S2A in ``compute_dtype``."""
    device = resolve_device(device)
    p = cfg["preprocess"]
    mel_cfg = MelConfig.from_preprocess_cfg(p)
    symbols, g2p = _symbols(cfg)

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
    msem = model.get("semantic_codec") or {}
    sem_cfg = RepCodecConfig(
        feature_dim=p["n_mel"], hidden=msem.get("hidden", 384),
        codebook_size=msem.get("codebook_size", 8192),
        codebook_dim=msem.get("codebook_dim", 8), num_blocks=msem.get("num_blocks", 4))
    ac_cfg = _codec_config(cfg)

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


def valle_inference(args, cfg: dict, logger) -> None:
    """Zero-shot VALL-E: [prompt audio + prompt text] + target text → wav."""
    device = resolve_device(args.device)
    model, tok, g2p, symbols = build_valle(args, cfg, logger, device)
    sr = cfg["preprocess"]["sample_rate"]
    phones = torch.tensor(g2p.to_ids(args.prompt_text + " " + args.text, symbols))[None]
    prompt_audio, _ = load_wav(args.prompt_audio, sr=sr)
    t = max(len(prompt_audio) // tok.hop * tok.hop, tok.hop)
    prompt_codes = tok.encode(prompt_audio[:t])[0]  # (Q, N)
    # the AR decodes in bf16 (a cast copy), the NAR runs the float32 weights, as JAX's do
    ar = prepare_for_decode(copy.deepcopy(model), "bfloat16")
    tokens0, lengths = ar_generate(ar, phones, prompt_codes[0][None],
                                   torch.Generator(device).manual_seed(0),
                                   max_new=args.max_new, top_k=args.top_k,
                                   compute_dtype="bfloat16")
    n = max(int(lengths[0]), 1)
    with torch.inference_mode():
        token_mask = (torch.arange(tokens0.shape[1], device=device) < n).float()[None]
        phones = phones.to(device)
        codes = model.nar_generate(phones, torch.ones_like(phones, dtype=torch.float32),
                                   tokens0, token_mask, prompt_codes[None])
        wav = tok.decode(codes[:, :, :n])[0].float().cpu().numpy()
    save_wav(args.output_path, wav, sr)
    logger.info(f"wrote {args.output_path} ({n * tok.hop / sr:.2f}s)")


def maskgct_zeroshot_inference(args, cfg: dict, logger) -> None:
    """MaskGCT zero-shot TTS: prompt audio + prompt text + target text → wav
    through `MaskGCTPipeline.__call__` (g2p → T2S → S2A → codec decode)."""
    pipe = build_maskgct_pipeline(args, cfg, logger, device=args.device)
    sr = cfg["preprocess"]["sample_rate"]
    prompt, _ = load_wav(args.prompt_audio, sr=sr)
    wav = pipe(prompt, args.prompt_text, args.text, seed=0)
    save_wav(args.output_path, wav, sr)
    logger.info(f"wrote {args.output_path} ({len(wav) / sr:.2f}s)")


def vits_inference(args, cfg: dict, logger) -> dict:
    """VITS: text → waveform through `VITS.infer` → {frames of the frame
    mask, samples written}."""
    device = resolve_device(args.device)
    p = cfg["preprocess"]
    exp_dir = Path(cfg.get("log_dir", "ckpts")) / args.exp_name
    spk2id = json.loads((exp_dir / "spk2id.json").read_text())
    symbols, g2p = _symbols(cfg)
    ids = g2p.to_ids(args.text, symbols)
    if p.get("add_blank", True):
        ids = intersperse(ids, 0)
    state, epoch, step = CheckpointManager(exp_dir / "checkpoint").restore_raw(
        map_location="cpu")
    model = VITS(vits_config(cfg, len(symbols), len(spk2id)))
    model.load_state_dict(state["g"]["model"])
    model = model.to(device).eval().requires_grad_(False)
    logger.info(f"restored from epoch {epoch} step {step}")
    sid = None
    if len(spk2id) > 1:
        sid = torch.tensor([spk2id.get(getattr(args, "speaker", ""), 0)], device=device)
    phones = torch.tensor(ids, device=device)[None]
    with torch.inference_mode():
        wav, fmask, _ = model.infer(phones, torch.ones_like(phones, dtype=torch.float32), sid,
                                    args.noise_scale, args.length_scale, 0.8, args.max_frames,
                                    generator=torch.Generator(device).manual_seed(0))
    frames = int(fmask.sum())
    n = frames * model.cfg.decoder.hop_size
    save_wav(args.output_path, wav[0, :n].float().cpu().numpy(), p["sample_rate"])
    logger.info(f"wrote {args.output_path} ({n / p['sample_rate']:.2f}s)")
    return {"frames": frames, "samples": n}


def _vocode(mel: torch.Tensor, args, cfg: dict, logger) -> torch.Tensor:
    """mel (B, N, n_mel) → waveform (B, T): the GAN vocoder of
    ``--vocoder_ckpt``, else Griffin-Lim."""
    p = cfg["preprocess"]
    if getattr(args, "vocoder_ckpt", ""):
        voc_fn, _ = load_vocoder(args.vocoder_ckpt, p["n_mel"],
                                 getattr(args, "vocoder_config", ""), fallback_cfg=cfg,
                                 device=mel.device)
        return voc_fn(mel)
    logger.info("no --vocoder_ckpt: Griffin-Lim reconstruction")
    return mel_to_audio(mel.transpose(1, 2), MelConfig.from_preprocess_cfg(p))


def fastspeech2_inference(args, cfg: dict, logger) -> dict:
    """Two-stage FastSpeech2: phones → predicted durations, pitch and energy
    → mel → vocoder (or Griffin-Lim) → {frames of the frame mask, samples
    written}. The phone table is the one the trainer grew from the
    TextGrids."""
    device = resolve_device(args.device)
    p = cfg["preprocess"]
    exp_dir = Path(cfg.get("log_dir", "ckpts")) / args.exp_name
    symbols = SymbolTable.from_file(exp_dir / "symbols.dict")
    g2p = G2PModule(p.get("g2p_backend", "char"), p.get("lexicon_path") or None)
    ids = g2p.to_ids(args.text, symbols)
    if not ids:
        raise ValueError("no phones mapped into the trained symbol table")
    state, epoch, step = _model_state(exp_dir / "checkpoint")
    logger.info(f"FastSpeech2 restored from epoch {epoch} step {step}")
    n_speakers = state["spk.weight"].shape[0] if "spk.weight" in state else 0
    model = FastSpeech2(fs2_config(cfg, len(symbols), n_speakers))
    model.load_state_dict(state)
    model = model.to(device).eval().requires_grad_(False)
    phones = torch.tensor(ids, device=device)[None]
    sid = torch.zeros(1, dtype=torch.int64, device=device) if n_speakers else None
    with torch.inference_mode():
        out = model(phones, torch.ones_like(phones, dtype=torch.float32), sid=sid,
                    d_control=args.length_scale)
        n = int(out["frame_mask"].sum())
        wav = _vocode(out["mel_postnet"][:, :n], args, cfg, logger)
    save_wav(args.output_path, wav[0].float().cpu().numpy(), p["sample_rate"])
    logger.info(f"wrote {args.output_path} ({n * p['hop_size'] / p['sample_rate']:.2f}s)")
    return {"frames": n, "samples": wav.shape[-1]}


MODES = {"VALLE": valle_inference, "MaskGCT": maskgct_zeroshot_inference,
         "FastSpeech2": fastspeech2_inference, "VITS": vits_inference}
NOT_PORTED = {"Jets": "A6.4", "NaturalSpeech2": "A6.4"}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--exp_name", default="exp")
    ap.add_argument("--text", default="")
    ap.add_argument("--speaker", default="")
    ap.add_argument("--output_path", default="")
    ap.add_argument("--testing_set", default="",
                    help="processed split name (e.g. test, golden_test)")
    ap.add_argument("--output_dir", default="")
    ap.add_argument("--noise_scale", type=float, default=0.667)
    ap.add_argument("--length_scale", type=float, default=1.0)
    ap.add_argument("--max_frames", type=int, default=1000)
    ap.add_argument("--prompt_audio", default="")
    ap.add_argument("--prompt_text", default="")
    ap.add_argument("--codec_ckpt", default="")
    ap.add_argument("--semantic_ckpt", default="")
    ap.add_argument("--weights_dir", default="",
                    help="manifest of per-module port checkpoints (MaskGCT)")
    ap.add_argument("--vocoder_ckpt", default="",
                    help="GAN vocoder checkpoint (FastSpeech2; Griffin-Lim if empty)")
    ap.add_argument("--vocoder_config", default="",
                    help="vocoder exp config (else exp_config.json next to --vocoder_ckpt)")
    ap.add_argument("--max_new", type=int, default=512, help="VALL-E AR decode budget")
    ap.add_argument("--top_k", type=int, default=50)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


def _run_single(args, cfg: dict, logger):
    model_type = cfg.get("model_type")
    if model_type in NOT_PORTED:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported (ROADMAP A6: {NOT_PORTED[model_type]}); "
            f"the port's TTS CLI runs {sorted(MODES)}")
    return MODES.get(model_type, vits_inference)(args, cfg, logger)


def main(argv=None):
    """Run the CLI; one request returns what its mode returns (VITS and
    FastSpeech2: the frames and samples written)."""
    args = parse_args(argv)
    strict_float32()
    cfg = load_config(args.config)
    logger = get_logger("tts_infer")
    if args.testing_set:
        from amphion_tpu_torch.data.metadata import load_metadata

        if not args.output_dir:
            raise SystemExit("--testing_set needs --output_dir")
        out_dir = Path(args.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        utts = []
        for ds in cfg["dataset"]:
            utts.extend(load_metadata(Path(cfg["preprocess"]["processed_dir"]) / ds
                                      / f"{args.testing_set}.json"))
        logger.info(f"batch inference over {len(utts)} utterances ({args.testing_set})")
        for u in utts:
            sub = copy.copy(args)
            sub.testing_set, sub.text, sub.speaker = "", u.text or "", u.speaker or ""
            sub.output_path = str(out_dir / f"{u.uid}.wav")
            _run_single(sub, cfg, logger)
        return
    if not (args.text and args.output_path):
        raise SystemExit("need --text and --output_path")
    return _run_single(args, cfg, logger)


if __name__ == "__main__":
    main()
