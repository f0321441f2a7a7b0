"""Codec-LM TTS trainers (port of `VALLETrainer` and `MaskGCTTrainer` of
`amphion_tpu/runtime/tts_trainer.py`): one eager PyTorch step a batch
(forward, backward, optax's global-norm clip, AdamW) over what
`bins/tts/preprocess.py` wrote.

Both read ``<processed_dir>/<dataset>/train.json``, keep the utterances
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

Each loss's backward runs before the next loss's forward (the AR before
the NAR, T2S before S2A): the gradients are their sum, as JAX's one
backward of the summed loss gives, and only one model's activations are
held at a time. Attention runs kernels 6 and 7 in every layer of every
step. The port adds ``--device`` (default ``cuda``) and reads
``train.metrics_path`` (a JSONL file of per-step metrics and wall times).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

from amphion_tpu_torch.data.dataset import Prefetcher, pad_batch
from amphion_tpu_torch.data.metadata import load_metadata
from amphion_tpu_torch.data.samplers import LengthBucketSampler
from amphion_tpu_torch.models.tts.maskgct.maskgct import (
    MaskGCTS2A,
    MaskGCTT2S,
    S2AConfig,
    T2SConfig,
)
from amphion_tpu_torch.models.tts.valle.valle import VALLE, VALLEConfig
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.runtime.loop import LoopConfig, TrainLoop
from amphion_tpu_torch.runtime.optimizers import ClipAdamW, maybe_accumulate
from amphion_tpu_torch.runtime.train_state import TrainState
from amphion_tpu_torch.text.symbol_table import SymbolTable
from amphion_tpu_torch.utils.convert import init_like_flax
from amphion_tpu_torch.utils.device import resolve_device, strict_float32
from amphion_tpu_torch.utils.logging import get_logger, model_summary

PHONES_HINT = ("set preprocess.extract_phone true (config/base.json sets it false) and run "
               "bins/tts/preprocess.py")


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
        t = self.cfg["train"]
        ckpt_dir = Path(self.cfg.get("log_dir", "ckpts")) / self.args.exp_name / "checkpoint"
        self.ckpt = CheckpointManager(ckpt_dir, list(t.get("save_checkpoint_stride", [1])),
                                      list(t.get("keep_last", [-1])))
        self.loop = TrainLoop(
            LoopConfig(max_epoch=t.get("max_epoch", -1), max_steps=t.get("max_steps", -1),
                       log_interval=t.get("log_interval", 100),
                       save_checkpoints_steps=t.get("save_checkpoints_steps", 0),
                       metrics_path=t.get("metrics_path", "")),
            self.step, state, self._data, ckpt=self.ckpt, logger=self.logger)
        if getattr(self.args, "resume", False):
            self.loop.resume(getattr(self.args, "resume_from_ckpt_path", None) or None,
                             getattr(self.args, "resume_type", "resume"))

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


TRAINERS = {"VALLE": VALLETrainer, "MaskGCT": MaskGCTTrainer}
