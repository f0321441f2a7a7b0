"""Vevo flow-matching transformer (port of
`amphion_tpu/models/vc/flow_matching_transformer.py`): content-style tokens
and a clean prompt mel → target mel, by integrating the estimated flow from
noise over a Python loop of ODE steps; and the training loss
(`FlowMatchingTransformer.loss`).

The estimator runs in the dtype its parameters were cast to, once, when the
pipeline was built (``compute_dtype``, see `prepare_for_inference`); with
int8 or int4 its projections are quantized then too and run through kernel
4 or 5, with bf16 activations. The ODE state and the CFG std-rescale stay
float32, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch
from torch import nn

from amphion_tpu_torch.modules.llama import (
    MLP2,
    LlamaConfig,
    LlamaEncoder,
    cast_params,
    load_quantized,
    sinusoidal_step_embedding,
)
from amphion_tpu_torch.modules.flow_matching import cfm_loss, cfm_pair
from amphion_tpu_torch.ops.ragged import masked_std, pack_segments, unpack_target

SOLVERS = ("euler", "midpoint")
TIME_SCHEDULERS = ("linear", "cos")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.bfloat16, "int4": torch.bfloat16}  # → activation dtype


@dataclass(frozen=True)
class FMTConfig:
    token_vocab: int = 8192
    n_mel: int = 80
    hidden: int = 1024
    num_layers: int = 16
    num_heads: int = 16
    max_position: int = 8192
    cond_scale_factor: int = 1  # nearest upsampling of the condition stream
    decode_quant: str = "none"  # "none" | "int8" | "int4" estimator projections
    sigma_min: float = 1e-5  # of the CFM interpolant (training)
    time_scheduler: str = "linear"  # flow-time draw in training: "linear" or "cos"
    remat: bool = False  # recompute the estimator's blocks in the backward

    def __post_init__(self):
        if self.time_scheduler not in TIME_SCHEDULERS:
            raise ValueError(f"time_scheduler {self.time_scheduler!r} not in "
                             f"{TIME_SCHEDULERS}")

    def llama(self) -> LlamaConfig:
        return LlamaConfig(
            hidden_size=self.hidden, num_layers=self.num_layers,
            num_heads=self.num_heads, adaptive=True,
            intermediate_size=self.hidden * 4, max_position=self.max_position,
            decode_quant=self.decode_quant, remat=self.remat)


class DiffLlamaMel(nn.Module):
    """x = mel_mlp(x) + cond_mlp(cond); adaptive-norm encoder on the flow
    time embedding; mel_out_mlp head."""

    def __init__(self, cfg: LlamaConfig, n_mel: int):
        super().__init__()
        h = cfg.hidden_size
        self.hidden = h
        self.mel_mlp = MLP2(n_mel, h)
        self.cond_mlp = MLP2(h, h)
        self.diff_step_mlp = MLP2(h, h)
        self.encoder = LlamaEncoder(cfg)
        self.mel_out_mlp = MLP2(h, h, out=n_mel)

    def forward(self, x, t, cond, mask=None):
        """x (B, T, n_mel); t (B,) flow time in [0, 1]; cond (B, T, D)."""
        h = self.mel_mlp(x) + self.cond_mlp(cond)
        d = self.diff_step_mlp(
            sinusoidal_step_embedding(t, self.hidden).to(h.dtype))
        return self.mel_out_mlp(self.encoder(h, cond=d, mask=mask))


class FlowMatchingTransformer(nn.Module):
    def __init__(self, cfg: FMTConfig):
        super().__init__()
        self.cfg = cfg
        self.cond_emb = nn.Embedding(cfg.token_vocab, cfg.hidden)
        self.diff_estimator = DiffLlamaMel(cfg.llama(), cfg.n_mel)

    def _cond(self, tokens):
        # out-of-vocabulary ids (from an untrained AR stage) are clipped
        cond = self.cond_emb(torch.clamp(tokens, 0, self.cfg.token_vocab - 1))
        if self.cfg.cond_scale_factor != 1:
            cond = cond.repeat_interleave(self.cfg.cond_scale_factor, dim=1)
        return cond

    def velocity(self, x_t, t, tokens, prompt_mel, prompt_len_mask, x_mask,
                 drop_cond=False):
        """Flow at x_t (B, T, n_mel); prompt frames (prompt_len_mask > 0)
        enter clean from prompt_mel; the condition is zeroed if drop_cond."""
        cond = self._cond(tokens)[:, : x_t.shape[1]]
        if drop_cond:
            cond = torch.zeros_like(cond)
        x_in = torch.where(prompt_len_mask[..., None] > 0, prompt_mel, x_t)
        return self.diff_estimator(x_in, t, cond, mask=x_mask)

    def loss(self, mel, tokens, prompt_len_mask, x_mask,
             generator: torch.Generator | None = None, t=None, noise=None):
        """CFM loss on the non-prompt frames (JAX `loss`): t ~ U(0, 1) clipped
        to [1e-5, 1] (then ``1 - cos(t·π/2)`` under the cos scheduler), the
        condition dropped for rows without a prompt, prompt frames entering
        clean, the loss weighted by ``x_mask · (1 − prompt_len_mask)``.
        mel (B, T, n_mel); tokens (B, T); masks (B, T). ``t`` (B,), the
        uniform draw before clipping, and ``noise`` (B, T, n_mel) replace
        the draws from ``generator``. Returns (loss, {"fm_loss": loss})."""
        c = self.cfg
        b = mel.shape[0]
        if t is None:
            t = torch.rand((b,), generator=generator, device=mel.device)
        t = torch.clamp(t, 1e-5, 1.0)
        if c.time_scheduler == "cos":
            t = 1.0 - torch.cos(t * math.pi * 0.5)
        if noise is None:
            noise = torch.randn(mel.shape, generator=generator, device=mel.device)
        x_t, v_target = cfm_pair(mel, t, noise, c.sigma_min)
        has_prompt = (prompt_len_mask.sum(dim=1) > 0)[:, None, None]
        cond = self._cond(tokens)[:, : mel.shape[1]] * has_prompt.to(mel.dtype)
        x_in = torch.where(prompt_len_mask[..., None] > 0, mel, x_t)
        v_pred = self.diff_estimator(x_in, t, cond, mask=x_mask)
        loss = cfm_loss(v_pred, v_target, x_mask * (1.0 - prompt_len_mask))
        return loss, {"fm_loss": loss}

    def flow_eval(self, xt, t, cond_tokens, prompt_mel, cfg=1.0,
                  rescale_cfg=0.75):
        """One flow evaluation on [prompt; x_t]; with cfg > 0 a second pass on
        the target alone with a zero condition, combined by the std-rescale
        (population std over the whole batch, as ``jnp.std``)."""
        lp = prompt_mel.shape[1]
        x_full = torch.cat([prompt_mel, xt], dim=1)
        cond = self._cond(cond_tokens)[:, : x_full.shape[1]].to(xt.dtype)
        flow = self.diff_estimator(x_full, t, cond)[:, lp:].float()
        if cfg > 0:
            un = self.diff_estimator(xt, t, torch.zeros_like(cond[:, lp:])).float()
            pos_std = flow.std(unbiased=False)
            flow_cfg = flow + cfg * (flow - un)
            rescaled = flow_cfg * pos_std / torch.clamp(
                flow_cfg.std(unbiased=False), min=1e-12)
            flow = rescale_cfg * rescaled + (1 - rescale_cfg) * flow_cfg
        return flow


def prepare_for_inference(model: FlowMatchingTransformer,
                          compute_dtype: str) -> FlowMatchingTransformer:
    """The model an ODE in ``compute_dtype`` runs (JAX `_fmt_quant_prep` and
    `_fmt_cast_params`): float32/bf16 cast the parameters; int8/int4 rebuild
    the model with quantized estimator projections (fused q/k/v and
    gate/up) from its bf16-cast weights. Call once, when the pipeline is
    built."""
    if compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r} not in {tuple(DTYPES)}")
    if compute_dtype in ("float32", "bfloat16"):
        return cast_params(model, DTYPES[compute_dtype])
    qcfg = dataclasses.replace(model.cfg, decode_quant=compute_dtype)
    with torch.device(next(model.parameters()).device):
        qmodel = FlowMatchingTransformer(qcfg)
    return load_quantized(qmodel, model, qcfg.llama())


def _check(model: FlowMatchingTransformer, solver: str, compute_dtype: str):
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; expected one of {SOLVERS}")
    if compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r} not in {tuple(DTYPES)}")
    dt = DTYPES[compute_dtype]
    quant = compute_dtype if compute_dtype in ("int8", "int4") else "none"
    have = next(model.parameters()).dtype
    if have != dt or model.cfg.decode_quant != quant:
        raise ValueError(f"the flow-matching model holds {have} weights and "
                         f"{model.cfg.decode_quant} projections but compute_dtype "
                         f"is {compute_dtype}: cast it once with "
                         "prepare_for_inference when it is built")
    return dt


def _integrate(flow_at, xt, b, num_steps, solver):
    """Euler at midpoint times (i + 0.5)/n, or explicit midpoint (RK2)."""
    h = 1.0 / num_steps
    ones = torch.ones((b,), dtype=torch.float32, device=xt.device)
    for i in range(num_steps):
        if solver == "midpoint":
            t0 = ones * float(i) * h
            k1 = flow_at(xt, t0)
            xt = xt + h * flow_at(xt + 0.5 * h * k1, t0 + 0.5 * h)
        else:
            xt = xt + h * flow_at(xt, ones * (float(i) + 0.5) * h)
    return xt


@torch.inference_mode()
def fmt_inference(model: FlowMatchingTransformer, tokens: torch.Tensor,
                  prompt_mel: torch.Tensor, generator: torch.Generator | None = None,
                  num_steps: int = 32, cfg_scale: float = 0.0,
                  rescale_cfg: float = 0.75, compute_dtype: str = "bfloat16",
                  noise: torch.Tensor | None = None, solver: str = "euler"):
    """ODE from noise to mel with the prompt-prefix protocol and optional CFG.

    tokens (B, Lp+Lt) frame-aligned content-style tokens; prompt_mel
    (B, Lp, n_mel) clean prompt mel; ``noise`` (B, Lt, n_mel) replaces the
    draw from ``generator``. Returns the generated target mel (B, Lt, n_mel)
    in float32."""
    dt = _check(model, solver, compute_dtype)
    b, lp = tokens.shape[0], prompt_mel.shape[1]
    lt = tokens.shape[1] * model.cfg.cond_scale_factor - lp
    if noise is None:
        noise = torch.randn((b, lt, model.cfg.n_mel), generator=generator,
                            device=tokens.device)
    pm = prompt_mel.to(dt)

    def flow_at(xt, t):
        return model.flow_eval(xt.to(dt), t, tokens, pm, cfg_scale, rescale_cfg)

    return _integrate(flow_at, noise.float(), b, num_steps, solver)


@torch.inference_mode()
def fmt_inference_ragged(model: FlowMatchingTransformer,
                         prompt_tokens: torch.Tensor, prompt_tok_len: torch.Tensor,
                         target_tokens: torch.Tensor, target_tok_len: torch.Tensor,
                         prompt_mel: torch.Tensor,
                         generators: list[torch.Generator] | None = None,
                         num_steps: int = 32, cfg_scale: float = 0.0,
                         rescale_cfg: float = 0.75, compute_dtype: str = "bfloat16",
                         noise: torch.Tensor | None = None, solver: str = "euler"):
    """Ragged batched `fmt_inference`: B requests with their own prompt and
    target lengths in one padded batch (the serving path).

    Each step packs ``[prompt_i | target_i | pad]`` left-aligned (exact
    rotary positions), masks the pad keys, and, with CFG, takes the std
    rescale per sample over its valid target frames, so a request's result
    does not depend on the batch it is in. ``generators`` gives one noise
    stream per request, each drawn as (Lt_max, n_mel); ``noise``
    (B, Lt_max, n_mel) replaces them. Returns (B, Lt_tok_max * csf, n_mel),
    valid through each row's own ``target_tok_len * csf`` frames."""
    dt = _check(model, solver, compute_dtype)
    csf = model.cfg.cond_scale_factor
    b, lp_tok = prompt_tokens.shape
    lp, lt = lp_tok * csf, target_tokens.shape[1] * csf
    if prompt_mel.shape[1] != lp:
        raise ValueError(f"prompt_mel has {prompt_mel.shape[1]} frames, expected {lp}")
    dev = prompt_tokens.device
    p_len = prompt_tok_len.to(dev, torch.long) * csf
    t_len = target_tok_len.to(dev, torch.long) * csf
    tok_full = pack_segments([prompt_tokens.long(), target_tokens.long()],
                             [prompt_tok_len.to(dev), target_tok_len.to(dev)])
    cond = model._cond(tok_full).to(dt)
    x_mask = (torch.arange(lp + lt, device=dev)[None, :]
              < (p_len + t_len)[:, None]).float()
    t_valid = torch.arange(lt, device=dev)[None, :] < t_len[:, None]
    t_mask = t_valid.float()[..., None]
    if noise is None:
        noise = torch.stack([
            torch.randn((lt, model.cfg.n_mel), generator=g, device=dev)
            for g in generators])
    pm = prompt_mel.to(dt)
    zero_cond = torch.zeros((b, lt, cond.shape[-1]), dtype=dt, device=dev)

    def flow_at(xt, t):
        x_full = pack_segments([pm, xt.to(dt)], [p_len, t_len])
        flow_full = model.diff_estimator(x_full, t, cond, x_mask)
        flow = unpack_target(flow_full, p_len, lt).float()
        if cfg_scale > 0:
            un = model.diff_estimator(xt.to(dt), t, zero_cond,
                                      t_valid.float()).float()
            pos_std = masked_std(flow, t_valid)
            flow_cfg = flow + cfg_scale * (flow - un)
            rescaled = flow_cfg * pos_std / torch.clamp(
                masked_std(flow_cfg, t_valid), min=1e-12)
            flow = rescale_cfg * rescaled + (1 - rescale_cfg) * flow_cfg
        return flow * t_mask

    return _integrate(flow_at, noise.float() * t_mask, b, num_steps, solver)
