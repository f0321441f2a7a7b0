"""Training loop (port of `amphion_tpu/runtime/loop.py`), single device.

Epoch mode (``max_epoch``) or step mode (``max_steps``); logging every
``log_interval`` steps, a guard that raises on a non-finite metric, step-mode
checkpoints every ``save_checkpoints_steps`` and at the last step,
epoch-mode checkpoints by the manager's strides, resume, and a JSONL
metrics file (one line per step with its wall time). All compute lives in ``train_step(state,
batch) -> (state, metrics)``.

One difference from JAX, on purpose: a checkpoint records how many batches
of its epoch were consumed, and a resume skips them (``data_fn(skip)``),
so that a run resumed from any checkpoint repeats the uninterrupted run's
steps; the JAX loop restarts the epoch's batches from the first. The data
parallel mesh, the TensorBoard writer and the profiler window are not
ported: setting them raises.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterable

from amphion_tpu_torch.runtime.checkpoint import CheckpointManager
from amphion_tpu_torch.utils.logging import ValueWindow, get_logger


@dataclass
class LoopConfig:
    max_epoch: int = -1  # epoch mode when > 0
    max_steps: int = -1  # step mode when > 0
    log_interval: int = 100
    save_checkpoints_steps: int = 0  # step-mode checkpoint cadence
    nan_guard: bool = True
    metrics_path: str = ""  # JSONL per-step metrics
    tensorboard_dir: str = ""  # not ported: must stay empty
    profile_steps: tuple = ()  # not ported: must stay empty


class TrainLoop:
    def __init__(self, cfg: LoopConfig, train_step: Callable, states: Any,
                 data_fn: Callable[[int], Iterable], ckpt: CheckpointManager | None = None,
                 logger=None, mesh: Any = None):
        """``data_fn(skip)`` yields one epoch's batches from the ``skip``-th on."""
        if mesh is not None:
            raise NotImplementedError("the data-parallel mesh is not ported")
        if cfg.tensorboard_dir:
            raise NotImplementedError("the TensorBoard writer is not ported")
        if cfg.profile_steps:
            raise NotImplementedError("the profiler window is not ported")
        self.cfg = cfg
        self.train_step = train_step
        self.states = states
        self.data_fn = data_fn
        self.ckpt = ckpt
        self.logger = logger or get_logger("train")
        self.step = 0
        self.epoch = 0
        self.batch_in_epoch = 0  # batches of the current epoch already consumed
        self._window = ValueWindow(100)
        self._metrics_path = Path(cfg.metrics_path) if cfg.metrics_path else None
        if self._metrics_path is not None:
            self._metrics_path.parent.mkdir(parents=True, exist_ok=True)

    def resume(self, checkpoint_path: str | None = None, resume_type: str = "resume"):
        if self.ckpt is None:
            raise ValueError("resume needs a CheckpointManager")
        self.states, self.epoch, self.step, self.batch_in_epoch = self.ckpt.restore(
            self.states, checkpoint_path, resume_type)
        if resume_type == "finetune":
            self.batch_in_epoch = 0
        self.logger.info(f"resumed from epoch {self.epoch}, step {self.step}, "
                         f"batch {self.batch_in_epoch} of the epoch ({resume_type})")

    def _save(self, loss: float) -> None:
        self.ckpt.save(self.states, self.epoch, self.step, loss, self.batch_in_epoch)

    def _record(self, metrics: dict, seconds: float) -> None:
        if self._metrics_path is None:
            return
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps({"step": self.step, "epoch": self.epoch, "step_s": seconds,
                                "sec_per_step": self._window.average, **metrics}) + "\n")

    def run(self) -> Any:
        step_mode = self.cfg.max_steps > 0
        last_loss = float("nan")
        while True:
            if not step_mode and 0 < self.cfg.max_epoch <= self.epoch:
                break
            epoch_metrics: dict[str, float] = {}
            n_batches = 0
            batches = iter(self.data_fn(self.batch_in_epoch))
            try:
                for batch in batches:
                    t0 = time.perf_counter()
                    self.states, metrics = self.train_step(self.states, batch)
                    metrics = {k: float(v) for k, v in metrics.items()}
                    seconds = time.perf_counter() - t0
                    self._window.append(seconds)
                    self.step += 1
                    self.batch_in_epoch += 1
                    self._record(metrics, seconds)
                    n_batches += 1
                    for k, v in metrics.items():
                        epoch_metrics[k] = epoch_metrics.get(k, 0.0) + v
                    if self.cfg.nan_guard and not all(math.isfinite(v) for v in metrics.values()):
                        raise FloatingPointError(
                            f"non-finite loss at step {self.step}: {metrics}")
                    last_loss = next(iter(metrics.values()))
                    if self.step % self.cfg.log_interval == 0:
                        msg = ", ".join(f"{k}={v:.4f}" for k, v in metrics.items())
                        self.logger.info(f"epoch {self.epoch} step {self.step} | {msg} | "
                                         f"{self._window.average * 1e3:.1f} ms/step")
                    last = step_mode and self.step >= self.cfg.max_steps
                    if self.ckpt is not None and (last or (
                            step_mode and self.cfg.save_checkpoints_steps > 0
                            and self.step % self.cfg.save_checkpoints_steps == 0)):
                        self._save(last_loss)  # once, when a cadence step is the last
                    if last:
                        return self.states
            finally:
                close = getattr(batches, "close", None)
                if close is not None:
                    close()
            if n_batches == 0 and self.batch_in_epoch == 0:
                raise ValueError("the data gave no batch in a whole epoch (fewer "
                                 "utterances than one batch?)")
            self.epoch += 1
            self.batch_in_epoch = 0
            if self.ckpt is not None and not step_mode and self.ckpt.should_save(self.epoch):
                mean_loss = (epoch_metrics[next(iter(epoch_metrics))] / max(1, n_batches)
                             if epoch_metrics else float("nan"))
                self._save(mean_loss)
        return self.states
