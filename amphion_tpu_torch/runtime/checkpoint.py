"""Checkpoints (port of `amphion_tpu/runtime/checkpoint.py`): the
reference's retention rules on the port's own format.

Directory names carry epoch, step and loss as in JAX
(``epoch-0001_step-0000004_loss-1.234567``); ``save_checkpoint_stride`` ×
``keep_last`` lists choose what is kept, with a ``ckpts.json`` ledger beside
the checkpoints and deletion only of names no stride retains. A checkpoint
directory holds one ``state.pt``: `torch.save` of the train state's model,
optimizer and generator states (of each named state, for `TrainStates`)
with its step, epoch and the number of batches of that epoch already
consumed (so a resume continues inside the epoch). The JAX package writes
Orbax directories, which the port cannot read: restoring one raises and
says so.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

STATE = "state.pt"
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt", "checkpoint")


def _ckpt_name(epoch: int, step: int, loss: float) -> str:
    return f"epoch-{epoch:04d}_step-{step:07d}_loss-{loss:.6f}"


def parse_ckpt_name(name: str) -> tuple[int, int]:
    """(epoch, step) from a checkpoint directory name."""
    parts = dict(p.split("-", 1) for p in Path(name).name.split("_"))
    return int(parts["epoch"]), int(parts["step"])


class CheckpointManager:
    """Stride-based retention with a ckpts.json ledger."""

    def __init__(self, directory: str | Path, save_checkpoint_stride: list[int] | None = None,
                 keep_last: list[int] | None = None):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.strides = list(save_checkpoint_stride or [1])
        self.keep_last = list(keep_last or [-1] * len(self.strides))
        self._retained: list[list[str]] = [[] for _ in self.strides]
        self._ledger_path = self.directory / "ckpts.json"
        if self._ledger_path.is_file():
            ledger = json.loads(self._ledger_path.read_text())
            self._retained = ledger.get("retained", self._retained)

    def should_save(self, epoch: int) -> bool:
        return any(epoch % s == 0 for s in self.strides)

    def save(self, state, epoch: int, step: int, loss: float,
             batch_in_epoch: int = 0) -> str | None:
        """Write ``state`` (a `TrainState` or `TrainStates`) under the
        strides that take ``epoch``; returns the directory, or None when no
        stride does."""
        hit = [i for i, s in enumerate(self.strides) if epoch % s == 0]
        if not hit:
            return None
        name = _ckpt_name(epoch, step, loss)
        path = self.directory / name
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / (STATE + ".tmp")
        torch.save({**state.state_dict(), "epoch": epoch,
                    "batch_in_epoch": batch_in_epoch}, tmp)
        tmp.replace(path / STATE)
        to_delete: set[str] = set()
        for i in hit:
            self._retained[i].append(name)
            k = self.keep_last[i]
            if k >= 0 and len(self._retained[i]) > k:
                to_delete.update(self._retained[i][:-k] if k else self._retained[i])
                self._retained[i] = self._retained[i][-k:] if k else []
        keep = {n for lst in self._retained for n in lst}
        for old in to_delete - keep:  # only names no other stride retains
            shutil.rmtree(self.directory / old, ignore_errors=True)
        self._ledger_path.write_text(json.dumps({"retained": self._retained}))
        return str(path)

    def latest(self) -> str | None:
        """The newest checkpoint directory (or the directory itself when the
        manager was pointed at one checkpoint)."""
        if self.directory.name.startswith("epoch-"):
            return str(self.directory)
        cands = sorted(p.name for p in self.directory.iterdir()
                       if p.is_dir() and p.name.startswith("epoch-"))
        return str(self.directory / cands[-1]) if cands else None

    def restore_raw(self, checkpoint_path: str | None = None,
                    map_location=None) -> tuple[dict, int, int]:
        """The saved dictionary of a checkpoint (the latest by default) →
        (state, epoch, step). The file is mapped, not read: a tensor is paged
        in when it is used, so an inference that takes a trained model's
        weights leaves its optimizer moments unread. Raises on an Orbax
        directory."""
        path = Path(checkpoint_path or self.latest() or "")
        if not path.name:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        if not (path / STATE).is_file():
            if path.is_dir() and any((path / m).exists() for m in ORBAX_MARKERS):
                raise ValueError(
                    f"{path} is an Orbax checkpoint of the JAX package; the port "
                    f"reads only its own format ({STATE} from torch.save)")
            raise FileNotFoundError(f"{path} holds no {STATE}")
        epoch, step = parse_ckpt_name(path.name)
        state = torch.load(path / STATE, map_location=map_location, weights_only=True,
                           mmap=True)
        return state, epoch, step

    def restore(self, state, checkpoint_path: str | None = None,
                resume_type: str = "resume") -> tuple[object, int, int, int]:
        """Restore the whole train state (``resume``) or the models' weights
        only (``finetune``) in place, a `TrainState` or `TrainStates` →
        (state, epoch, step, batches of the epoch already consumed)."""
        if resume_type not in ("resume", "finetune"):
            raise ValueError(f"resume_type {resume_type!r} is not resume/finetune")
        saved, epoch, step = self.restore_raw(checkpoint_path, map_location=state.device)
        state.load_state_dict(saved, weights_only=resume_type == "finetune")
        return state, epoch, step, int(saved.get("batch_in_epoch", 0))
