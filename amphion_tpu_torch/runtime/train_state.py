"""Train state (port of `amphion_tpu/runtime/train_state.py`): the step
count, the model, its optimizer and the random generator that replaces the
JAX state's key. PyTorch updates the model and the optimizer in place, so
`TrainState.apply_gradients` returns the same object; a checkpoint holds
all four (`runtime/checkpoint.py`). `TrainStates` names several states
that step and checkpoint together (the GAN trainer's ``{"g", "d"}``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: object  # `ClipAdamW` or `MultiSteps` (runtime/optimizers.py)
    generator: torch.Generator

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def apply_gradients(self, grads: list[torch.Tensor]) -> "TrainState":
        """One optimizer update from one gradient per trainable parameter."""
        self.optimizer.apply(grads)
        self.step += 1
        return self

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: dict, weights_only: bool = False) -> None:
        """The whole state, or the model's weights alone (``weights_only``,
        the JAX ``finetune`` resume)."""
        self.model.load_state_dict(state["model"])
        if weights_only:
            return
        self.step = int(state["step"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"].cpu())


class TrainStates(dict):
    """Train states by name, checkpointed as one dictionary of their state
    dictionaries (``{"g": {"model": ..., "step": ...}, "d": {...}}``)."""

    @property
    def device(self) -> torch.device:
        return next(iter(self.values())).device

    def state_dict(self) -> dict:
        return {name: s.state_dict() for name, s in self.items()}

    def load_state_dict(self, state: dict, weights_only: bool = False) -> None:
        for name, s in self.items():
            s.load_state_dict(state[name], weights_only)
