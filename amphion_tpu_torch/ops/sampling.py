"""Token sampling: top-k / top-p (nucleus) filtering and a categorical draw
(port of `amphion_tpu/ops/sampling.py`).

Randomness comes from explicit ``torch.Generator``s: one for the whole
batch, or one per row, so a request's draws do not depend on the batch it
is in. The draw is the Gumbel-max form of a categorical sample
(``argmax(logits + Gumbel noise)``, as ``jax.random.categorical``); torch's
and JAX's random streams differ, so only the distribution matches JAX.
"""

from __future__ import annotations

import torch


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits per row, set the rest to -inf."""
    if k <= 0 or k >= logits.shape[-1]:  # no-op when k covers the vocab
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of logits with cumulative
    probability >= p (always the top one)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    thresh = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))).amin(-1, keepdim=True)
    return logits.masked_fill(logits < thresh, float("-inf"))


def _uniform(shape, generators, device) -> torch.Tensor:
    if isinstance(generators, (list, tuple)):
        if len(generators) != shape[0]:
            raise ValueError(f"{len(generators)} generators for {shape[0]} rows")
        return torch.stack([torch.rand(shape[1:], generator=g, device=device)
                            for g in generators])
    return torch.rand(shape, generator=generators, device=device)


def sample_logits(logits: torch.Tensor, generators=None, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Draw token ids (B, V) → (B,) int64 with temperature and top-k/p
    filtering; ``temperature <= 0`` takes the argmax and draws nothing.
    ``generators`` is one ``torch.Generator`` for the batch or a list with
    one per row."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    logits = top_k_filter(logits, top_k)
    logits = top_p_filter(logits, top_p)
    u = _uniform(logits.shape, generators, logits.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 2 ** -24)))
    return torch.argmax(logits + gumbel, dim=-1)
