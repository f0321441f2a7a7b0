"""Duration models (port of `amphion_tpu/modules/duration.py`): the
deterministic predictor, VITS's stochastic duration predictor (a flow over
log-durations, with a variational posterior for training) and the static-
shape length regulator.

Layouts are JAX's (B, T, C) and submodules carry the Flax scope names.
JAX draws the stochastic predictor's noises from a key; the port takes
them from the caller (``e_q`` in training, ``noise`` in sampling) or from a
``torch.Generator``, so a test can hand it JAX's own draws. Dropout is left
out: the JAX trainers run these with ``deterministic=True``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from amphion_tpu_torch.modules.flows import ConvFlow, DDSConv, ElementwiseAffine, log_flow
from amphion_tpu_torch.modules.transformer import conv_nlc, same_conv


class DurationPredictor(nn.Module):
    """Two masked conv-ReLU-LayerNorm blocks and a Dense → (B, T)
    log-durations; the input (and ``g``) carry no gradient back."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int = 3,
                 gin_channels: int = 0):
        super().__init__()
        if gin_channels:
            self.cond = nn.Linear(gin_channels, in_channels)
        self.Conv_0 = same_conv(in_channels, hidden_channels, kernel_size)
        self.LayerNorm_0 = nn.LayerNorm(hidden_channels, eps=1e-5)
        self.Conv_1 = same_conv(hidden_channels, hidden_channels, kernel_size)
        self.LayerNorm_1 = nn.LayerNorm(hidden_channels, eps=1e-5)
        self.Dense_0 = nn.Linear(hidden_channels, 1)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor | None = None,
                g: torch.Tensor | None = None) -> torch.Tensor:
        x = x.detach()
        if g is not None:
            x = x + self.cond(g.detach())
        m = 1.0 if x_mask is None else x_mask[..., None]
        x = self.LayerNorm_0(torch.relu(conv_nlc(self.Conv_0, x * m)))
        x = self.LayerNorm_1(torch.relu(conv_nlc(self.Conv_1, x * m)))
        x = self.Dense_0(x * m)
        return (x * m)[..., 0]


class StochasticDurationPredictor(nn.Module):
    """VITS's flow-based duration model. ``forward(..., w=...)`` returns the
    negative log-likelihood (B,) of the durations ``w`` (with the posterior
    noise ``e_q`` (B, T, 2)); ``reverse=True`` maps ``noise`` (B, T, 2),
    scaled by ``noise_scale``, to log-durations (B, T).

    The flows keep JAX's order: the posterior runs ``post_flow_pre`` and
    then each ``post_flow_i`` followed by a flip, with no flip between the
    affine and the first ConvFlow; the prior likewise, and its reverse
    drops the first ConvFlow (``flow_0``), as the reference does."""

    def __init__(self, hidden_channels: int = 192, kernel_size: int = 3, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        h, k = hidden_channels, kernel_size
        self.n_flows = n_flows
        self.pre = nn.Conv1d(h, h, 1)
        if gin_channels:
            self.cond = nn.Conv1d(gin_channels, h, 1)
        self.convs = DDSConv(h, k, 3)
        self.proj = nn.Conv1d(h, h, 1)
        self.flow_pre = ElementwiseAffine(2)
        for i in range(n_flows):
            self.add_module(f"flow_{i}", ConvFlow(2, h, k, 3))
        self.post_pre = nn.Conv1d(1, h, 1)
        self.post_convs = DDSConv(h, k, 3)
        self.post_proj = nn.Conv1d(h, h, 1)
        self.post_flow_pre = ElementwiseAffine(2)
        for i in range(4):
            self.add_module(f"post_flow_{i}", ConvFlow(2, h, k, 3))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor | None = None,
                w: torch.Tensor | None = None, g: torch.Tensor | None = None,
                reverse: bool = False, noise_scale: float = 1.0,
                e_q: torch.Tensor | None = None, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = conv_nlc(self.pre, x.detach())
        if g is not None:
            x = x + conv_nlc(self.cond, g.detach())
        x = conv_nlc(self.proj, self.convs(x, x_mask))
        if x_mask is not None:
            x = x * x_mask[..., None]
        mask3 = 1.0 if x_mask is None else x_mask[..., None]
        b, t = x.shape[:2]
        flows = [getattr(self, f"flow_{i}") for i in range(self.n_flows)]

        if not reverse:
            if w is None:
                raise ValueError("StochasticDurationPredictor: training needs w")
            w = w[..., None] if w.ndim == 2 else w  # (B, T, 1)
            h_w = conv_nlc(self.post_pre, w)
            h_w = conv_nlc(self.post_proj, self.post_convs(h_w, x_mask))
            if e_q is None:
                e_q = torch.randn((b, t, 2), generator=generator, device=x.device)
            e_q = e_q * mask3
            z_q, logdet_q = self.post_flow_pre(e_q, x_mask)
            for i in range(4):
                z_q, ld = getattr(self, f"post_flow_{i}")(z_q, x_mask, g=x + h_w)
                logdet_q = logdet_q + ld
                z_q = torch.flip(z_q, dims=(-1,))
            z_u, z1 = z_q[..., :1], z_q[..., 1:]
            u = torch.sigmoid(z_u) * mask3
            z0 = (w - u) * mask3
            logdet_q = logdet_q + torch.sum(
                (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * mask3, dim=(1, 2))
            logq = torch.sum(-0.5 * (math.log(2 * math.pi) + e_q ** 2) * mask3,
                             dim=(1, 2)) - logdet_q

            z0, logdet = log_flow(z0, x_mask)
            z, ld = self.flow_pre(torch.cat([z0, z1], dim=-1), x_mask)
            logdet = logdet + ld
            for f in flows:
                z, ld = f(z, x_mask, g=x)
                logdet = logdet + ld
                z = torch.flip(z, dims=(-1,))
            nll = torch.sum(0.5 * (math.log(2 * math.pi) + z ** 2) * mask3,
                            dim=(1, 2)) - logdet
            return nll + logq

        if noise is None:
            noise = torch.randn((b, t, 2), generator=generator, device=x.device)
        z = noise * noise_scale * mask3
        for f in reversed(flows[1:]):
            z = torch.flip(z, dims=(-1,))
            z = f(z, x_mask, g=x, reverse=True)
        z = torch.flip(z, dims=(-1,))
        z = self.flow_pre(z, x_mask, reverse=True)
        return z[..., 0]


def length_regulate(x: torch.Tensor, durations: torch.Tensor,
                    max_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand phone features (B, L, D) by integer durations (B, L) into a
    static ``max_len`` frames: frame t takes the phone whose cumulative
    interval holds it (the count of phones ending at or before t), frames
    past the total are zero → (expanded (B, max_len, D), mask (B, max_len)
    bool).

    The pick is a product with the one-hot (B, max_len, L) matrix, exact in
    float32 (one term a row), where JAX gathers: a gather's backward sums a
    phone's frames with atomics on the card, in an order that changes from
    run to run, and the product's backward sums them in a fixed order, so a
    resumed FastSpeech2 run repeats its weights to the bit."""
    cum = torch.cumsum(durations, dim=1)
    t = torch.arange(max_len, device=x.device)[None, :]
    idx = torch.sum(cum[:, None, :] <= t[:, :, None], dim=-1).clamp(0, x.shape[1] - 1)
    mask = t < cum[:, -1:]
    onehot = (idx[..., None] == torch.arange(x.shape[1], device=x.device)) & mask[..., None]
    return torch.bmm(onehot.to(x.dtype), x), mask
