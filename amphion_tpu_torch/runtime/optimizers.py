"""The trainers' optimizer (port of the chain that `bins/vc/train.py`
builds, ``optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr))``,
of the GAN vocoders' ``optax.adamw(optax.exponential_decay(lr, 1000,
0.999), b1, b2)`` (`models/vocoders/gan_trainer.make_optimizer`), and of
`maybe_accumulate` in `amphion_tpu/runtime/optimizers.py`).

optax's defaults are kept where they differ from PyTorch's:

- ``optax.adamw`` decays every parameter (biases and norm scales too) by
  weight_decay 1e-4, with betas (0.9, 0.999) and eps 1e-8;
  ``torch.optim.AdamW`` defaults to 1e-2. The update is the same decoupled
  AdamW, so `torch.optim.AdamW` carries it with optax's numbers (the
  VALL-E trainer's ``adamw(lr, b1, b2, weight_decay=0.01)`` passes its own).
- ``optax.clip_by_global_norm`` leaves the gradients alone below the norm
  and otherwise computes ``g / norm * max_norm``;
  ``torch.nn.utils.clip_grad_norm_`` multiplies by ``max_norm / (norm +
  1e-6)`` whenever the norm exceeds it.
- ``optax.exponential_decay`` (``staircase=False``) gives the n-th update
  (n = 0 first) the rate ``lr · decay_rate^(n / transition_steps)``.
- ``optax.MultiSteps`` averages the k micro-steps' gradients (a running
  mean) and applies the update on the k-th; the others leave the
  parameters as they are.

The optimizers work in place on the parameters (JAX returns new ones).
"""

from __future__ import annotations

import torch

OPTAX_ADAMW = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's rule, in place: the global norm sqrt(Σ g²) of ``grads``; if it
    is at least ``max_norm`` every gradient becomes ``g / norm * max_norm``.
    Returns the norm before clipping (a 0-d tensor)."""
    norm = torch.stack([torch.sum(g.float() * g.float()) for g in grads]).sum().sqrt()
    if norm.item() >= max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm


class ClipAdamW:
    """``chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    weight_decay))`` with optax's defaults over ``params``, the schedule
    ``exponential_decay(lr, decay_steps, decay_rate)`` (a constant ``lr`` at
    the default ``decay_rate`` 1); ``max_norm=None`` leaves out the clip.
    `apply` takes one gradient per parameter."""

    def __init__(self, params, lr: float, max_norm: float | None = 1.0,
                 betas: tuple[float, float] = OPTAX_ADAMW["betas"],
                 decay_rate: float = 1.0, decay_steps: int = 1,
                 weight_decay: float = OPTAX_ADAMW["weight_decay"]):
        self.params = list(params)
        self.max_norm = max_norm
        self.lr, self.decay_rate, self.decay_steps = lr, decay_rate, decay_steps
        self.count = 0  # updates applied
        self.adamw = torch.optim.AdamW(self.params, lr=lr, **{
            **OPTAX_ADAMW, "betas": tuple(betas), "weight_decay": weight_decay})

    def apply(self, grads: list[torch.Tensor]) -> None:
        """Clip ``grads`` (in place) and take one AdamW step at the
        schedule's rate."""
        if self.max_norm is not None:
            clip_by_global_norm_(grads, self.max_norm)
        for group in self.adamw.param_groups:
            group["lr"] = self.lr * self.decay_rate ** (self.count / self.decay_steps)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adamw.step()
        for p in self.params:
            p.grad = None
        self.count += 1

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = state.get("count", 0)  # absent where the rate was constant


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)``: the running mean
    ``acc + (g − acc) / (n + 1)`` of k micro-steps' gradients goes to
    ``inner.apply`` on the k-th call; the other calls change no parameter."""

    def __init__(self, inner: ClipAdamW, k: int):
        if k < 2:
            raise ValueError(f"MultiSteps needs k >= 2, got {k}")
        self.inner, self.k = inner, k
        self.mini_step = 0
        self.acc = None

    @property
    def params(self):
        return self.inner.params

    def apply(self, grads: list[torch.Tensor]) -> None:
        n = self.mini_step
        if self.acc is None:
            self.acc = [torch.zeros_like(g) for g in grads]
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / (n + 1))
        self.mini_step = (n + 1) % self.k
        if self.mini_step == 0:
            self.inner.apply(self.acc)
            self.acc = None

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.mini_step = state["mini_step"]
        self.acc = state["acc"]


def maybe_accumulate(opt: ClipAdamW, train_cfg: dict):
    """``opt`` wrapped in `MultiSteps` when ``train_cfg`` sets
    ``gradient_accumulation_steps`` above 1, else ``opt`` itself."""
    k = int(train_cfg.get("gradient_accumulation_steps", 1) or 1)
    return MultiSteps(opt, k) if k > 1 else opt
