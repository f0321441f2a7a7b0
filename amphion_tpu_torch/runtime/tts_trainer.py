"""TTS trainers (port of `VITSTrainer`, `VALLETrainer`,
`FastSpeech2Trainer` and `MaskGCTTrainer` of
`amphion_tpu/runtime/tts_trainer.py`): one eager PyTorch step a batch
over what `bins/tts/preprocess.py` wrote.

VITS and FastSpeech2 (the LJSpeech recipes) batch as JAX does: each
epoch's order is ``numpy.random.default_rng(epoch)``'s permutation of the
utterances, in full batches of ``train.batch_size``, a resume skipping the
batches its checkpoint had consumed. Their models are drawn from
``train.seed`` with the Flax initializers (`utils/convert.init_like_flax`)
and applied with dropout off, as JAX's trainers apply theirs
(``deterministic=True``).

- `VITSTrainer`: phones from ``<processed>/<ds>/phones/<uid>.json``
  (blanks interspersed where ``preprocess.add_blank``, default on) cut to
  ``train.max_phones``, audio cut to ``train.max_frames`` whole hops and
  its linear spectrogram made on the device; the step of
  `models/tts/vits/vits_trainer.make_vits_train_step` (G: VITS, D: MPD +
  MSD, ``model.discriminators``), each half with its decayed AdamW, the
  step's draws from the G state's generator. ``spk2id.json`` is written
  beside the checkpoints; the checkpoint holds both states (``"g"``,
  ``"d"``), of which `bins/tts/inference.py` reads ``g``.
- `FastSpeech2Trainer`: phones and durations from MFA TextGrids at
  ``<processed>/<ds>/textgrids/<uid>.TextGrid``
  (`data/processors/duration.textgrid_to_durations`), its symbol table
  grown from their phones and written to ``<exp>/symbols.dict``; each row
  cut to the phones that end within ``train.max_frames``, its audio to
  their frames in a zero batch of ``max_frames · hop`` samples; the log-mel
  (kernel 3 on the card), YIN F0 (`ops/f0`) and energy made on the device,
  log-F0 and energy standardised over the batch (JAX's rule, not dataset
  statistics); `fastspeech2_loss` and one optax ``adamw(lr)`` update at its
  defaults.

VALL-E and MaskGCT (the codec-LM recipes) read
``<processed_dir>/<dataset>/train.json``, keep the utterances
whose feature files all exist (phones from ``preprocess.extract_phone``,
which `config/base.json` sets off, so a recipe must set it on; codes from
``--extract_codes``; for MaskGCT semantic tokens and latents from
``--extract_semantic``), and batch them with
`data/samplers.LengthBucketSampler` (``train.max_tokens``, ``min_bucket``,
``seed``), each epoch's order the sampler's next pass, as in JAX, whose
trainers spend the first pass on the example batch of the models' init.
The models are drawn from ``train.seed`` with the Flax initializers
(`utils/convert.init_like_flax`); the step's draws come from the train
state's generator (seeded ``seed + 2``), which checkpoints with it.

- `VALLETrainer`: `VALLE.ar_loss` on codebook 0 plus `VALLE.nar_loss` on
  one drawn stage a row with the recipes' prefix prompt; AdamW with the
  config's ``adam_b1``/``adam_b2`` (0.9/0.95 where absent) and weight decay
  0.01, the clip at 1.0, ``gradient_accumulation_steps``. The checkpoint's
  ``"model"`` is the `VALLE` state dict.
- `MaskGCTTrainer`: `MaskGCTT2S.compute_loss` plus
  `MaskGCTS2A.compute_loss`, one optimizer (optax's ``adamw(lr)``
  defaults) and one clip over both. Rows are cut to the shortest of their
  semantic tokens, codes, latents and the bucket (the semantic tokens run
  at the mel's rate, the codes at the codec's). The S2A conditions on the
  latents (``sem_proj``, no ``cond_emb``, as Flax creates it), and the
  checkpoint's ``"model"`` is one state dict of keys ``t2s.*`` and
  ``s2a.*``, what `bins/tts/inference.build_maskgct_pipeline` loads.

In the codec-LM trainers each loss's backward runs before the next loss's
forward (the AR before the NAR, T2S before S2A): the gradients are their
sum, as JAX's one backward of the summed loss gives, and only one model's
activations are held at a time. Attention runs kernels 6 and 7 in every
layer of every step. The port adds ``--device`` (default ``cuda``) and reads
``train.metrics_path`` (a JSONL file of per-step metrics and wall times).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

from amphion_tpu_torch.data.audio_io import load_wav
from amphion_tpu_torch.data.dataset import Prefetcher, pad_batch
from amphion_tpu_torch.data.metadata import load_metadata
from amphion_tpu_torch.data.processors.duration import textgrid_to_durations
from amphion_tpu_torch.data.samplers import LengthBucketSampler
from amphion_tpu_torch.models.tts.fastspeech2.fs2 import (
    FastSpeech2,
    FastSpeech2Config,
    fastspeech2_loss,
)
from amphion_tpu_torch.models.tts.maskgct.maskgct import (
    MaskGCTS2A,
    MaskGCTT2S,
    S2AConfig,
    T2SConfig,
)
from amphion_tpu_torch.models.tts.valle.valle import VALLE, VALLEConfig
from amphion_tpu_torch.models.tts.vits.vits import VITS, VITSConfig
from amphion_tpu_torch.models.tts.vits.vits_trainer import (
    create_vits_states,
    make_vits_train_step,
)
from amphion_tpu_torch.models.vocoders.gan_trainer import GANTrainConfig
from amphion_tpu_torch.models.vocoders.hifigan import HiFiGANConfig
from amphion_tpu_torch.ops.energy import energy_from_log_mel
from amphion_tpu_torch.ops.f0 import F0Config, yin_f0
from amphion_tpu_torch.ops.mel import MelConfig, linear_spectrogram, mel_spectrogram
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.runtime.loop import LoopConfig, TrainLoop
from amphion_tpu_torch.runtime.optimizers import ClipAdamW, maybe_accumulate
from amphion_tpu_torch.runtime.train_state import TrainState, TrainStates
from amphion_tpu_torch.runtime.vocoder_trainer import build_discriminator
from amphion_tpu_torch.text.g2p import intersperse
from amphion_tpu_torch.text.symbol_table import SymbolTable
from amphion_tpu_torch.utils.convert import init_like_flax
from amphion_tpu_torch.utils.device import resolve_device, strict_float32
from amphion_tpu_torch.utils.logging import get_logger, model_summary

PHONES_HINT = ("set preprocess.extract_phone true (config/base.json sets it false) and run "
               "bins/tts/preprocess.py")


def _loop(cfg: dict, args, train_step, states, data_fn, logger) -> TrainLoop:
    """The train loop of ``cfg["train"]`` with checkpoints under
    ``log_dir/<exp_name>/checkpoint``, resumed where ``args.resume``."""
    t = cfg["train"]
    ckpt = CheckpointManager(Path(cfg.get("log_dir", "ckpts")) / args.exp_name / "checkpoint",
                             list(t.get("save_checkpoint_stride", [1])),
                             list(t.get("keep_last", [-1])))
    loop = TrainLoop(
        LoopConfig(max_epoch=t.get("max_epoch", -1), max_steps=t.get("max_steps", -1),
                   log_interval=t.get("log_interval", 100),
                   save_checkpoints_steps=t.get("save_checkpoints_steps", 0),
                   metrics_path=t.get("metrics_path", "")),
        train_step, states, data_fn, ckpt=ckpt, logger=logger)
    if getattr(args, "resume", False):
        loop.resume(getattr(args, "resume_from_ckpt_path", None) or None,
                    getattr(args, "resume_type", "resume"))
    return loop


class _CodecLMTrainer:
    """What both trainers share: utterances, the sampler, the step, the loop."""

    def _setup(self, args, cfg, name: str, features: dict[str, str]):
        """``features``: directory → file extension, each of which an
        utterance must have to be kept."""
        self.args, self.cfg = args, cfg
        self.logger = get_logger(name)
        self.device = resolve_device(getattr(args, "device", None))
        strict_float32()
        p = cfg["preprocess"]
        utts = []
        for ds in cfg["dataset"]:
            utts.extend(load_metadata(Path(p["processed_dir"]) / ds / "train.json"))
        self.dirs = {d: {ds: Path(p["processed_dir"]) / ds / d for ds in cfg["dataset"]}
                     for d in features}
        self.utts = [u for u in utts
                     if all((self.dirs[d][u.dataset] / f"{u.uid}.{ext}").is_file()
                            for d, ext in features.items())]
        self.symbols = SymbolTable.from_file(
            Path(p["processed_dir"]) / cfg["dataset"][0] / p["symbols_dict"])
        self.max_phones = cfg["train"].get("max_phones", 256)

    def _file(self, kind: str, u, ext: str = "npy") -> Path:
        return self.dirs[kind][u.dataset] / f"{u.uid}.{ext}"

    def _setup_sampler(self, lengths: list[int]) -> None:
        t = self.cfg["train"]
        self.sampler_args = dict(lengths=lengths, max_tokens=t.get("max_tokens", 8192),
                                 min_bucket=t.get("min_bucket", 64), seed=t.get("seed", 0))
        self._sampler, self._passes = None, 0

    def epoch_batches(self, epoch: int) -> list:
        """Epoch ``epoch``'s (indices, bucket) batches: the sampler's pass
        ``epoch + 2`` (JAX spends pass 1 on the init's example batch). Each
        pass reshuffles from the sampler's generator, so a resumed run (or
        an earlier epoch asked again) replays the passes before it."""
        if self._sampler is None or self._passes > epoch + 1:
            self._sampler, self._passes = LengthBucketSampler(**self.sampler_args), 0
        while self._passes <= epoch:
            next(iter(self._sampler))
            self._passes += 1
        self._passes += 1
        return list(self._sampler)

    def _phones(self, u) -> np.ndarray:
        ph = json.loads(self._file("phones", u, "json").read_text())
        return np.asarray(ph[: self.max_phones], np.int32)

    def _on_device(self, arrays: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()}

    def _build_state(self, model: nn.Module, opt: ClipAdamW) -> TrainState:
        seed = self.cfg["train"].get("seed", 0)
        return TrainState(0, model, maybe_accumulate(opt, self.cfg["train"]),
                          torch.Generator(self.device).manual_seed(seed + 2))

    def _init(self, model: nn.Module) -> nn.Module:
        g = torch.Generator(self.device).manual_seed(self.cfg["train"].get("seed", 0))
        return init_like_flax(model.to(self.device), g)

    def step(self, state: TrainState, batch: dict, draws: dict | None = None):
        """One training step: each loss's forward and backward in turn, then
        one optimizer update from the summed gradients. ``draws`` overrides
        the losses' random draws (`_losses`)."""
        state.model.train()
        params = state.optimizer.params
        for p in params:
            p.grad = None
        total, metrics = 0.0, {}
        for loss, aux in self._losses(state, batch, draws or {}):
            loss.backward()
            total = total + loss.detach()
            metrics.update({k: v.detach() for k, v in aux.items()})
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        state.apply_gradients(grads)
        return state, {"loss": total, **metrics}

    def _setup_loop(self, state: TrainState) -> None:
        self.loop = _loop(self.cfg, self.args, self.step, state, self._data, self.logger)

    def _data(self, skip: int = 0):
        """This epoch's batches from the ``skip``-th on, made ahead on a
        background thread."""
        batches = self.epoch_batches(self.loop.epoch)[skip:]

        def gen():
            for indices, bucket in batches:
                yield self.make_batch(indices, bucket)

        return Prefetcher(gen)

    def train_loop(self):
        return self.loop.run()


class VALLETrainer(_CodecLMTrainer):
    """VALL-E: the AR loss on codebook 0 and the NAR loss on a drawn stage,
    from phones and codec codes."""

    def __init__(self, args, cfg):
        self._setup(args, cfg, "valle", {"codes": "npy", "phones": "json"})
        if not self.utts:
            raise AssertionError("no utterances with codes+phones: run preprocess with "
                                 f"--extract_codes; {PHONES_HINT}")
        m = cfg["model"].get("valle") or {}
        with torch.device(self.device):
            model = VALLE(VALLEConfig(
                num_phones=max(len(self.symbols) + 1, 64),
                audio_vocab=m.get("audio_vocab", 1024),
                num_quantizers=m.get("num_quantizers", 8), hidden=m.get("hidden", 1024),
                num_layers=m.get("num_layers", 12), num_heads=m.get("num_heads", 16),
                max_position=m.get("max_position", 4096), remat=m.get("remat", False),
                prefix_mode=m.get("prefix_mode", 1)))
        self._setup_sampler([int(np.load(self._file("codes", u), mmap_mode="r").shape[-1])
                             for u in self.utts])
        model = self._init(model)
        model_summary({"valle": model}, self.logger)
        a = cfg["train"]["adamw"]
        opt = ClipAdamW(model.parameters(), a["lr"], 1.0,
                        betas=(a.get("adam_b1", 0.9), a.get("adam_b2", 0.95)),
                        weight_decay=a.get("weight_decay", 0.01))
        self._setup_loop(self._build_state(model, opt))

    def make_batch(self, indices: list[int], bucket: int) -> dict:
        phones, codes, code_lens = [], [], []
        for i in indices:
            u = self.utts[i]
            phones.append(self._phones(u))
            c = np.load(self._file("codes", u))  # (Q, N)
            codes.append(c[:, :bucket])
            code_lens.append(min(c.shape[1], bucket))
        ph, ph_len = pad_batch(phones)
        toks = np.zeros((len(codes), codes[0].shape[0], bucket), np.int64)
        for r, c in enumerate(codes):
            toks[r, :, : c.shape[1]] = c
        return self._on_device({
            "phones": ph.astype(np.int64),
            "phone_mask": (np.arange(ph.shape[1])[None] < ph_len[:, None]).astype(np.float32),
            "tokens": toks,
            "token_mask": (np.arange(bucket)[None] < np.asarray(code_lens)[:, None])
            .astype(np.float32)})

    def _losses(self, state: TrainState, batch: dict, draws: dict):
        """The AR loss, then the NAR loss (``draws``: ``stage``, ``plen``)."""
        m = state.model
        args = (batch["phones"], batch["phone_mask"])
        stage, prompt_mask = m.train_draws(batch["token_mask"], state.generator, **draws)
        ar = m.ar_loss(*args, batch["tokens"][:, 0], batch["token_mask"])
        yield ar, {"ar_loss": ar}
        nar = m.nar_loss(*args, batch["tokens"], batch["token_mask"], stage, prompt_mask)
        yield nar, {"nar_loss": nar}


class MaskGCTTrainer(_CodecLMTrainer):
    """MaskGCT: the T2S and S2A masked-generative losses, jointly."""

    def __init__(self, args, cfg):
        self._setup(args, cfg, "maskgct", {"phones": "json", "semantic": "npy",
                                           "semantic_feats": "npy", "codes": "npy"})
        if not self.utts:
            raise AssertionError("missing features: run preprocess with --extract_semantic "
                                 f"--extract_codes; {PHONES_HINT}")
        mt, ms = cfg["model"].get("t2s") or {}, cfg["model"].get("s2a") or {}
        u0 = self.utts[0]
        sem_dim = int(np.load(self._file("semantic_feats", u0), mmap_mode="r").shape[-1])
        n_q = int(np.load(self._file("codes", u0), mmap_mode="r").shape[0])
        with torch.device(self.device):
            t2s = MaskGCTT2S(T2SConfig(
                hidden=mt.get("hidden", 1024), num_layers=mt.get("num_layers", 16),
                num_heads=mt.get("num_heads", 16), codebook_size=mt.get("codebook_size", 8192),
                phone_vocab=max(len(self.symbols) + 1, 64), remat=mt.get("remat", False)))
            # conditioned on the semantic latents: sem_proj, and no cond_emb
            s2a = MaskGCTS2A(S2AConfig(
                hidden=ms.get("hidden", 1024), num_layers=ms.get("num_layers", 16),
                num_heads=ms.get("num_heads", 16), codebook_size=ms.get("codebook_size", 1024),
                num_quantizers=n_q, semantic_dim=sem_dim, remat=ms.get("remat", False)),
                token_cond=False, feature_cond=True)
        self._setup_sampler([int(np.load(self._file("semantic", u), mmap_mode="r").shape[-1])
                             for u in self.utts])
        # both from the seed's key, as JAX initializes them
        model = nn.ModuleDict({"t2s": self._init(t2s), "s2a": self._init(s2a)})
        model_summary(dict(model.named_children()), self.logger)
        opt = ClipAdamW(model.parameters(), cfg["train"]["adamw"]["lr"], 1.0)
        self._setup_loop(self._build_state(model, opt))

    def make_batch(self, indices: list[int], bucket: int) -> dict:
        b = len(indices)
        phones = []
        sem = np.zeros((b, bucket), np.int64)
        codes = feats = None
        x_len = np.zeros(b, np.int32)
        for r, i in enumerate(indices):
            u = self.utts[i]
            phones.append(self._phones(u))
            s = np.load(self._file("semantic", u))
            c = np.load(self._file("codes", u))
            f = np.load(self._file("semantic_feats", u))
            n = min(len(s), c.shape[1], f.shape[0], bucket)
            x_len[r] = n
            sem[r, :n] = s[:n]
            if codes is None:
                codes = np.zeros((b, c.shape[0], bucket), np.int64)
                feats = np.zeros((b, bucket, f.shape[1]), np.float32)
            codes[r, :, :n] = c[:, :n]
            feats[r, :n] = f[:n]
        ph, ph_len = pad_batch(phones)
        return self._on_device({
            "phones": ph.astype(np.int64),
            "phone_mask": (np.arange(ph.shape[1])[None] < ph_len[:, None]).astype(np.float32),
            "semantic": sem, "codes": codes, "semantic_feats": feats,
            "x_mask": (np.arange(bucket)[None] < x_len[:, None]).astype(np.float32)})

    def _losses(self, state: TrainState, batch: dict, draws: dict):
        """The T2S loss, then the S2A loss (``draws``: ``{"t2s": {...},
        "s2a": {...}}``, the keyword draws of each ``compute_loss``)."""
        t2s, s2a = state.model["t2s"], state.model["s2a"]
        yield t2s.compute_loss(batch["semantic"], batch["x_mask"], batch["phones"],
                               batch["phone_mask"], state.generator, **draws.get("t2s", {}))
        yield s2a.compute_loss(batch["codes"], batch["x_mask"], batch["semantic_feats"],
                               state.generator, **draws.get("s2a", {}))


class _EpochTrainer:
    """VITS's and FastSpeech2's batching: the epoch's permutation in full
    batches, made ahead on a background thread without gradients."""

    def _epoch_utts(self, epoch: int) -> list[list]:
        """Epoch ``epoch``'s batches of utterances, in JAX's order."""
        order = np.random.default_rng(epoch).permutation(len(self.utts))
        bs = self.batch_size
        return [[self.utts[j] for j in order[i: i + bs]]
                for i in range(0, len(order) - bs + 1, bs)]

    def _data(self, skip: int = 0):
        batches = self._epoch_utts(self.loop.epoch)[skip:]

        def gen():
            with torch.no_grad():
                for utts in batches:
                    yield self.make_batch(utts)

        return Prefetcher(gen)

    def _on_device(self, arrays: dict) -> dict:
        return {k: v if torch.is_tensor(v) else torch.from_numpy(v).to(self.device)
                for k, v in arrays.items()}

    def train_loop(self):
        return self.loop.run()


class VITSTrainer(_EpochTrainer):
    """VITS on the LJSpeech recipe: text encoder, posterior, flows, SDP and
    the HiFi-GAN decoder against MPD + MSD."""

    def __init__(self, args, cfg):
        self.args, self.cfg = args, cfg
        self.logger = get_logger("vits")
        self.device = resolve_device(getattr(args, "device", None))
        strict_float32()
        p, t, mcfg = cfg["preprocess"], cfg["train"], cfg["model"]
        self.mel_cfg = MelConfig.from_preprocess_cfg(p)
        self.hop = p["hop_size"]
        self.utts = []
        for ds in cfg["dataset"]:
            self.utts.extend(load_metadata(Path(p["processed_dir"]) / ds / "train.json"))
        speakers = sorted({u.speaker or u.singer or "default" for u in self.utts})
        self.spk2id = {s: i for i, s in enumerate(speakers)}
        self.symbols = SymbolTable.from_file(
            Path(p["processed_dir"]) / cfg["dataset"][0] / p["symbols_dict"])
        self.phone_dir = {ds: Path(p["processed_dir"]) / ds / p["phone_dir"]
                          for ds in cfg["dataset"]}
        self.model_cfg = vits_config(cfg, len(self.symbols), len(speakers))
        if self.model_cfg.decoder.hop_size != self.hop:
            raise ValueError(f"decoder hop {self.model_cfg.decoder.hop_size} != preprocess "
                             f"hop {self.hop}")
        self.batch_size = t["batch_size"]
        self.max_frames = t.get("max_frames", 600)
        self.max_phones = t.get("max_phones", 120)
        self.train_cfg = GANTrainConfig(
            lr=t["adamw"]["lr"], adam_b1=t["adamw"]["adam_b1"], adam_b2=t["adamw"]["adam_b2"],
            lr_decay=t["exponential_lr"]["lr_decay"],
            compute_dtype=t.get("compute_dtype", "float32"))
        seed = t.get("seed", 0)
        with torch.device(self.device):
            model = VITS(self.model_cfg)
            disc = build_discriminator(cfg)
        for i, module in enumerate((model, disc)):
            init_like_flax(module, torch.Generator(self.device).manual_seed(seed + i))
        model_summary({"vits": model, "discriminator": disc}, self.logger)
        g, d = create_vits_states(model, disc, self.train_cfg, seed + 2)
        step = make_vits_train_step(self.mel_cfg, self.train_cfg)

        def train_step(states: TrainStates, batch: dict):
            states["g"], states["d"], metrics = step(states["g"], states["d"], batch)
            return states, metrics

        self.loop = _loop(cfg, args, train_step, TrainStates(g=g, d=d), self._data,
                          self.logger)
        exp_dir = Path(cfg.get("log_dir", "ckpts")) / args.exp_name
        (exp_dir / "spk2id.json").write_text(json.dumps(self.spk2id))

    def _phones(self, u) -> list[int]:
        ids = json.loads((self.phone_dir[u.dataset] / f"{u.uid}.json").read_text())
        return intersperse(ids, 0) if self.cfg["preprocess"].get("add_blank", True) else ids

    def make_batch(self, utts: list) -> dict:
        """phones (B, L) int64, phone_mask (B, L), spec (B, T, n_fft/2+1),
        spec_mask (B, T), audio (B, T · hop) and sid (B,) on the device."""
        phones, audios = [], []
        for u in utts:
            phones.append(np.asarray(self._phones(u)[: self.max_phones], np.int64))
            x, _ = load_wav(u.path, sr=self.mel_cfg.sample_rate)
            n = min(len(x), self.max_frames * self.hop)
            audios.append(x[: n // self.hop * self.hop])
        ph, ph_len = pad_batch(phones)
        au, au_len = pad_batch(audios)
        audio = torch.from_numpy(au).to(self.device)
        spec = linear_spectrogram(audio, self.mel_cfg).transpose(1, 2)
        return self._on_device({
            "phones": ph,
            "phone_mask": (np.arange(ph.shape[1])[None] < ph_len[:, None]).astype(np.float32),
            "spec": spec,
            "spec_mask": (np.arange(spec.shape[1])[None] < (au_len // self.hop)[:, None])
            .astype(np.float32),
            "audio": audio,
            "sid": np.asarray([self.spk2id.get(u.speaker or u.singer or "default", 0)
                               for u in utts], np.int64)})


def vits_config(cfg: dict, n_symbols: int, n_speakers: int) -> VITSConfig:
    """The `VITSConfig` of ``cfg["model"]`` (``vits``, ``decoder``) and the
    train block's ``segment_size``, as the JAX trainer and CLI build it."""
    m = cfg["model"].get("vits") or {}
    dec = cfg["model"].get("decoder")
    inter = m.get("inter_channels", 192)
    return VITSConfig(
        num_phones=max(n_symbols + 1, 64), spec_channels=cfg["preprocess"]["n_fft"] // 2 + 1,
        inter_channels=inter, hidden_channels=m.get("hidden_channels", 192),
        filter_channels=m.get("filter_channels", 768), n_heads=m.get("n_heads", 2),
        n_layers=m.get("n_layers", 6), n_speakers=n_speakers if n_speakers > 1 else 0,
        segment_size=cfg["train"].get("segment_size", 32),
        decoder=(HiFiGANConfig.from_model_cfg(dec, n_mel=inter) if dec
                 else HiFiGANConfig(n_mel=inter)))


def fs2_config(cfg: dict, n_symbols: int, n_speakers: int) -> FastSpeech2Config:
    """The `FastSpeech2Config` of ``cfg["model"]["fastspeech2"]``, the mel
    width and ``train.max_frames``, as the JAX trainer and CLI build it."""
    m = cfg["model"].get("fastspeech2") or {}
    return FastSpeech2Config(
        num_phones=max(n_symbols + 1, 64), hidden=m.get("hidden", 256),
        n_enc_layers=m.get("n_enc_layers", 4), n_dec_layers=m.get("n_dec_layers", 6),
        n_heads=m.get("n_heads", 2), ffn_hidden=m.get("ffn_hidden", 1024),
        kernel_size=m.get("kernel_size", 9), n_mel=cfg["preprocess"]["n_mel"],
        max_frames=cfg["train"].get("max_frames", 600),
        n_speakers=n_speakers if n_speakers > 1 else 0)


class FastSpeech2Trainer(_EpochTrainer):
    """FastSpeech2 on MFA durations: mel, pitch and energy targets made on
    the device a batch."""

    def __init__(self, args, cfg):
        self.args, self.cfg = args, cfg
        self.logger = get_logger("fs2")
        self.device = resolve_device(getattr(args, "device", None))
        strict_float32()
        p, t = cfg["preprocess"], cfg["train"]
        self.mel_cfg = MelConfig.from_preprocess_cfg(p)
        self.f0_cfg = F0Config.from_preprocess_cfg(p)
        self.hop = p["hop_size"]
        utts, self.align = [], {}
        table = SymbolTable.from_symbols(["_", "sil"])
        for ds in cfg["dataset"]:
            for u in load_metadata(Path(p["processed_dir"]) / ds / "train.json"):
                tg = Path(p["processed_dir"]) / ds / "textgrids" / f"{u.uid}.TextGrid"
                if not tg.is_file():
                    continue
                phones, durs = textgrid_to_durations(tg, self.hop, p["sample_rate"])
                for ph in phones:
                    table.add(ph)
                self.align[u.uid] = (phones, durs)
                utts.append(u)
        if not utts:
            raise AssertionError("no utterances with TextGrids; run MFA over the corpus "
                                 "exported by prepare_mfa_corpus()")
        self.utts, self.symbols = utts, table
        speakers = sorted({u.speaker or "default" for u in utts})
        self.spk2id = {s: i for i, s in enumerate(speakers)}
        self.batch_size = t["batch_size"]
        self.max_frames = t.get("max_frames", 600)
        with torch.device(self.device):
            model = FastSpeech2(fs2_config(cfg, len(table), len(speakers)))
        init_like_flax(model, torch.Generator(self.device).manual_seed(t.get("seed", 0)))
        model_summary({"fastspeech2": model}, self.logger)
        opt = ClipAdamW(model.parameters(), t["adamw"]["lr"], max_norm=None)
        state = TrainState(0, model, opt,
                           torch.Generator(self.device).manual_seed(t.get("seed", 0) + 1))
        self.loop = _loop(cfg, args, self.step, state, self._data, self.logger)
        self.symbols.to_file(Path(cfg.get("log_dir", "ckpts")) / args.exp_name
                             / "symbols.dict")

    def make_batch(self, utts: list) -> dict:
        """phones (B, L) int64, phone_mask, durations (B, L) int64, pitch
        and energy (B, max_frames), mel (B, max_frames, n_mel) and sid (B,)
        on the device."""
        mf, hop = self.max_frames, self.hop
        audios, phone_rows, dur_rows = [], [], []
        for u in utts:
            phones, durs = self.align[u.uid]
            ids = np.asarray([self.symbols[ph] for ph in phones], np.int64)
            keep = np.cumsum(durs) <= mf
            if not keep.any():  # the first phone alone outlasts max_frames
                keep[0] = True
                durs = np.minimum(durs, mf)
            phone_rows.append(ids[keep])
            dur_rows.append(np.asarray(durs, np.int64)[keep])
            x, _ = load_wav(u.path, sr=self.mel_cfg.sample_rate)
            n = int(dur_rows[-1].sum())
            seg = np.zeros(mf * hop, np.float32)
            seg[: min(len(x), n * hop)] = x[: n * hop]
            audios.append(seg)
        ph, ph_len = pad_batch(phone_rows)
        du, _ = pad_batch(dur_rows)
        au = torch.from_numpy(np.stack(audios)).to(self.device)
        mel = mel_spectrogram(au, self.mel_cfg)  # (B, n_mel, N)
        f0, _ = yin_f0(au, self.f0_cfg)
        energy = energy_from_log_mel(mel)
        pitch = torch.log1p(f0)
        pitch = (pitch - pitch.mean()) / (pitch.std(unbiased=False) + 1e-5)
        energy = (energy - energy.mean()) / (energy.std(unbiased=False) + 1e-5)
        return self._on_device({
            "phones": ph,
            "phone_mask": (np.arange(ph.shape[1])[None] < ph_len[:, None]).astype(np.float32),
            "durations": du, "pitch": pitch, "energy": energy, "mel": mel.transpose(1, 2),
            "sid": np.asarray([self.spk2id.get(u.speaker or "default", 0) for u in utts],
                              np.int64)})

    def step(self, state: TrainState, batch: dict):
        """One AdamW step on `fastspeech2_loss` with the batch's durations,
        pitch and energy teacher-forced → (state, the loss parts and total)."""
        model = state.model
        out = model(batch["phones"], batch["phone_mask"], batch["durations"], batch["pitch"],
                    batch["energy"], batch["sid"])
        loss, aux = fastspeech2_loss(out, batch)
        params = state.optimizer.params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        state.apply_gradients([torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)])
        return state, {**{k: v.detach() for k, v in aux.items()}, "loss": loss.detach()}


TRAINERS = {"VITS": VITSTrainer, "VALLE": VALLETrainer, "FastSpeech2": FastSpeech2Trainer,
            "MaskGCT": MaskGCTTrainer}
