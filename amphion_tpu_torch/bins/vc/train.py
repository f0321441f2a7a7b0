"""Vevo training CLI (port of `bins/vc/train.py`): the flow-matching (FM) and
autoregressive (AR) stages, one eager PyTorch step each (forward, backward,
optax's global-norm clip, AdamW).

    python -m amphion_tpu_torch.bins.vc.train --config config/vevo.json \\
        --model_type FlowMatchingTransformer --exp_name fm [--device cpu]

As in JAX, both trainers make their token streams online in the batch
maker: the log-mel of each segment (kernel 3 on the card), then RepCodec
tokenizers over it. Attention runs through the flash kernels, forward
(kernel 6) and backward (kernel 7), in every layer of every step.
Tokenizers without a checkpoint get random weights drawn from
``crc32(name)``; the models are drawn from ``train.seed`` with the Flax
initializers (`utils/convert.init_like_flax`).

Not ported (raise or are absent): the Vevo1.5 prosody stream
(``model.ar.style_vocab > 0``), Orbax tokenizer checkpoints, the
data-parallel loop, TensorBoard and the profiler window. The port adds
``--device`` (default ``cuda``) and reads ``train.metrics_path`` (a JSONL
file of per-step metrics and wall times).
"""

from __future__ import annotations

import argparse
import zlib
from pathlib import Path

import numpy as np
import torch

from amphion_tpu_torch.data.dataset import Prefetcher, SegmentAudioDataset
from amphion_tpu_torch.data.metadata import load_metadata
from amphion_tpu_torch.models.codec.repcodec import RepCodec, RepCodecConfig
from amphion_tpu_torch.models.vc.ar_transformer import ARTransformer, ARTransformerConfig
from amphion_tpu_torch.models.vc.flow_matching_transformer import (
    FlowMatchingTransformer,
    FMTConfig,
)
from amphion_tpu_torch.ops.mel import MelConfig, mel_spectrogram
from amphion_tpu_torch.pipelines.vevo_pipeline import duration_reduce
from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.runtime.loop import LoopConfig, TrainLoop
from amphion_tpu_torch.runtime.optimizers import ClipAdamW, maybe_accumulate
from amphion_tpu_torch.runtime.train_state import TrainState
from amphion_tpu_torch.utils.config import load_config
from amphion_tpu_torch.utils.convert import init_like_flax
from amphion_tpu_torch.utils.device import resolve_device, strict_float32
from amphion_tpu_torch.utils.logging import get_logger, model_summary


class _VevoTrainerBase:
    """What both stages share: data, tokenizers, the step, the loop."""

    def _setup(self, args, cfg, name: str):
        self.cfg = cfg
        self.logger = get_logger(name)
        self.device = resolve_device(getattr(args, "device", None))
        strict_float32()
        t = cfg["train"]
        self.batch_size = t["batch_size"]
        self.frames = t.get("segment_frames", 256)
        p = cfg["preprocess"]
        self.mel_cfg = MelConfig.from_preprocess_cfg(p)
        utts = []
        for ds in cfg["dataset"]:
            utts.extend(load_metadata(Path(p["processed_dir"]) / ds / "train.json"))
        self.dataset = SegmentAudioDataset(utts, p["sample_rate"], self.frames * p["hop_size"])
        self.first_grads = None  # what the first step's backward gave (see `_step`)

    def _setup_tokenizer(self, name: str, ckpt_path: str, vocab: int):
        """A RepCodec tokenizer over the mel (``encode``: (B, T, n_mel) →
        (B, T) tokens)."""
        m = self.cfg["model"].get(name) or {}
        codec = RepCodec(RepCodecConfig(
            feature_dim=self.cfg["preprocess"]["n_mel"], hidden=m.get("hidden", 128),
            codebook_size=vocab, codebook_dim=m.get("codebook_dim", 8),
            num_blocks=m.get("num_blocks", 2))).to(self.device)
        if ckpt_path:
            state, _, step = CheckpointManager(ckpt_path).restore_raw(
                map_location=self.device)
            codec.load_state_dict(state["model"])
            self.logger.info(f"{name} restored from step {step}")
        else:
            self.logger.warning(f"no checkpoint for {name}: RANDOM weights (smoke)")
            g = torch.Generator(self.device).manual_seed(zlib.crc32(name.encode()))
            init_like_flax(codec, g)
        return codec.eval().requires_grad_(False)

    def _mel(self, idxs: list[int]) -> torch.Tensor:
        """(B, frames, n_mel) log-mel of the batch's segments."""
        audio = np.stack([self.dataset[i]["audio"] for i in idxs])
        y = torch.from_numpy(audio).to(self.device)
        return mel_spectrogram(y, self.mel_cfg).transpose(1, 2)

    @staticmethod
    def _encode(codec: RepCodec, mel: torch.Tensor) -> torch.Tensor:
        # a clone leaves inference mode, so autograd may save the tokens
        return codec.encode(mel).clone()

    def _build_state(self, model: torch.nn.Module) -> TrainState:
        t = self.cfg["train"]
        seed = t.get("seed", 0)
        model = init_like_flax(model.to(self.device),
                               torch.Generator(self.device).manual_seed(seed))
        model_summary({self.stage: model}, self.logger)
        opt = maybe_accumulate(ClipAdamW(model.parameters(), t["adamw"]["lr"]), t)
        return TrainState(0, model, opt, torch.Generator(self.device).manual_seed(seed + 2))

    def _step(self, state: TrainState, batch: dict):
        """One training step: the loss, its gradients, one optimizer update.
        The first step of a run records which parameters got no gradient or
        an all-zero one (``first_grads``) and warns about them."""
        state.model.train()
        loss, aux = self._loss(state, batch)
        params = state.optimizer.params
        for p in params:
            p.grad = None
        loss.backward()
        if self.first_grads is None:
            names = {id(p): n for n, p in state.model.named_parameters()}
            missing = [names[id(p)] for p in params if p.grad is None]
            zero = [names[id(p)] for p in params if p.grad is not None and not p.grad.any()]
            self.first_grads = {"tensors": len(params), "missing": missing, "all_zero": zero}
            if missing or zero:
                self.logger.warning(f"first step: no gradient for {missing}, "
                                    f"an all-zero gradient for {zero}")
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        state.apply_gradients(grads)
        return state, {k: v.detach() for k, v in aux.items()}

    def _setup_loop(self, args, state: TrainState):
        t = self.cfg["train"]
        ckpt_dir = Path(self.cfg.get("log_dir", "ckpts")) / args.exp_name / "checkpoint"
        self.ckpt = CheckpointManager(ckpt_dir, list(t.get("save_checkpoint_stride", [1])),
                                      list(t.get("keep_last", [-1])))
        self.loop = TrainLoop(
            LoopConfig(max_epoch=t.get("max_epoch", -1), max_steps=t.get("max_steps", -1),
                       log_interval=t.get("log_interval", 100),
                       save_checkpoints_steps=t.get("save_checkpoints_steps", 0),
                       metrics_path=t.get("metrics_path", "")),
            self._step, state, self._data, ckpt=self.ckpt, logger=self.logger)
        if getattr(args, "resume", False):
            self.loop.resume(None, getattr(args, "resume_type", "resume"))

    def _data(self, skip: int = 0):
        """This epoch's full batches, in the epoch's own permutation, from the
        ``skip``-th on."""
        n = len(self.dataset)
        order = np.random.default_rng(self.loop.epoch).permutation(n)
        starts = list(range(0, n - self.batch_size + 1, self.batch_size))[skip:]

        def gen():
            with torch.no_grad():
                for i in starts:
                    yield self._make_batch(order[i: i + self.batch_size].tolist())

        return Prefetcher(gen)

    def train_loop(self):
        return self.loop.run()


class FlowMatchingTransformerTrainer(_VevoTrainerBase):
    """Vevo FM stage: content-style tokens → mel with the prompt-prefix
    timbre protocol."""

    stage = "fm"

    def __init__(self, args, cfg):
        self._setup(args, cfg, "fmt")
        m = cfg["model"].get("fm") or {}
        vocab = m.get("token_vocab", 8192)
        self.style_tokenizer = self._setup_tokenizer(
            "style_tokenizer", getattr(args, "style_ckpt", ""), vocab)
        with torch.device(self.device):
            model = FlowMatchingTransformer(FMTConfig(
                token_vocab=vocab, n_mel=cfg["preprocess"]["n_mel"],
                hidden=m.get("hidden", 1024), num_layers=m.get("num_layers", 16),
                num_heads=m.get("num_heads", 16), remat=m.get("remat", False)))
        self._setup_loop(args, self._build_state(model))

    def _loss(self, state: TrainState, batch: dict):
        return state.model.loss(batch["mel"], batch["tokens"], batch["prompt_mask"],
                                batch["x_mask"], generator=state.generator)

    def _make_batch(self, idxs: list[int]) -> dict:
        mel = self._mel(idxs)
        tokens = self._encode(self.style_tokenizer, mel)
        b, n = tokens.shape
        # a random prompt prefix of 10-40 % of the frames carries the timbre
        rng = np.random.default_rng(int(tokens[0, 0]) + b)
        plen = rng.integers(n // 10, max(n // 10 + 1, int(n * 0.4)), b)
        pmask = (np.arange(n)[None, :] < plen[:, None]).astype(np.float32)
        return {"mel": mel, "tokens": tokens,
                "prompt_mask": torch.from_numpy(pmask).to(self.device),
                "x_mask": torch.ones((b, n), device=self.device)}


class AutoregressiveTransformerTrainer(_VevoTrainerBase):
    """Vevo AR stage: duration-reduced content tokens → content-style
    tokens."""

    stage = "ar"

    def __init__(self, args, cfg):
        self._setup(args, cfg, "ar")
        m = cfg["model"].get("ar") or {}
        if m.get("style_vocab", 0):
            raise NotImplementedError("the Vevo1.5 prosody stream (style_vocab > 0) "
                                      "is not ported")
        in_vocab, out_vocab = m.get("input_vocab", 32), m.get("output_vocab", 8192)
        self.content_tokenizer = self._setup_tokenizer(
            "content_tokenizer", getattr(args, "content_ckpt", ""), in_vocab)
        self.style_tokenizer = self._setup_tokenizer(
            "style_tokenizer", getattr(args, "style_ckpt", ""), out_vocab)
        with torch.device(self.device):
            model = ARTransformer(ARTransformerConfig(
                input_vocab=in_vocab, output_vocab=out_vocab, hidden=m.get("hidden", 1024),
                num_layers=m.get("num_layers", 16), num_heads=m.get("num_heads", 16),
                remat=m.get("remat", False)))
        self.max_content = cfg["train"].get("max_content_tokens", self.frames)
        self._setup_loop(args, self._build_state(model))

    def _loss(self, state: TrainState, batch: dict):
        return state.model.loss(batch["input_tokens"], batch["input_mask"],
                                batch["output_tokens"], batch["output_mask"])

    def _make_batch(self, idxs: list[int]) -> dict:
        mel = self._mel(idxs)
        content = self._encode(self.content_tokenizer, mel).cpu()
        style = self._encode(self.style_tokenizer, mel)
        b, n = style.shape
        mc = self.max_content
        inp = torch.zeros((b, mc), dtype=torch.long)
        in_len = torch.zeros((b,), dtype=torch.long)
        for r in range(b):
            red = duration_reduce(content[r])[:mc]
            inp[r, : len(red)] = red
            in_len[r] = len(red)
        return {"input_tokens": inp.to(self.device),
                "input_mask": (torch.arange(mc)[None] < in_len[:, None]).float()
                .to(self.device),
                "output_tokens": style,
                "output_mask": torch.ones((b, n), device=self.device)}


TRAINERS = {
    "FlowMatchingTransformer": FlowMatchingTransformerTrainer,
    "AutoregressiveTransformer": AutoregressiveTransformerTrainer,
}


def main(argv: list[str] | None = None):
    """Parse ``argv`` (the command line by default), train, and return the
    trainer."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--exp_name", default="exp")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--resume_type", default="resume")
    parser.add_argument("--content_ckpt", default="")
    parser.add_argument("--style_ckpt", default="")
    parser.add_argument("--prosody_ckpt", default="")
    parser.add_argument("--model_type", default="",
                        help="override cfg.model_type (one config can drive "
                             "both the AR and FM stages)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; raises without a card)")
    args = parser.parse_args(argv)
    strict_float32()
    if args.prosody_ckpt:
        raise NotImplementedError("the prosody tokenizer (Vevo1.5) is not ported")
    cfg = load_config(args.config)
    if args.model_type:
        cfg["model_type"] = args.model_type
    if cfg["model_type"] not in TRAINERS:
        raise ValueError(f"model_type {cfg['model_type']!r} not in {sorted(TRAINERS)}")
    trainer = TRAINERS[cfg["model_type"]](args, cfg)
    trainer.train_loop()
    return trainer


if __name__ == "__main__":
    main()
