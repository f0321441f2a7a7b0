"""Weight bridge: load a JAX/Flax parameter tree into a port module.

The port names its submodules after the Flax scopes, so one walk over the
module's parameters finds each one's leaf in the tree by its dotted path
(``diff_estimator.encoder.layer_3.attn.q_proj`` → ``tree["diff_estimator"]
["encoder"]["layer_3"]["attn"]["q_proj"]``) and converts the layout:

- Linear ``kernel`` (in, out) → ``weight`` (out, in); ``bias`` as is;
- Conv1d ``kernel`` (k, in/groups, out) → ``weight`` (out, in/groups, k),
  Conv2d ``kernel`` (kh, kw, in, out) → ``weight`` (out, in, kh, kw): the
  plain convolutions (strided or not) of NSF-HiFiGAN's source, Vocos and
  the MS-STFT and MS-SB-CQT discriminators;
- weight-normalised convolutions (`WNConv1d`, `WNConv2d`,
  `WNConvTranspose1d`) and Dense (`WNLinear`): the kernel as a Conv's (a
  2-D one's (kh, kw, in/groups, out) → (out, in/groups, kh, kw)), a
  ConvTranspose's (k, in, out) → (in, out, k) reversed along k, a Dense's
  (in, out) → (out, in); the ``scale`` from the one sibling ``WeightNorm_*``
  scope that holds the leaf ``"<name>/kernel/scale"``;
- LayerNorm ``scale`` → ``weight``; Embedding ``embedding`` → ``weight``;
- any other parameter (RMSNorm ``scale``, ConvNeXt ``gamma``, a VQ
  ``codebook``, MaskGCT's ``mask_emb``, VITS's relative embeddings
  ``rel_k``/``rel_v``, a flow's ``m``/``logs``, FastSpeech2's
  ``pitch_bins`` and Postnet's ``bn_i_scale``/``bn_i_bias``) carries over
  under its own name;
- a quantized projection (`QDense`, `QDense4`) takes ``kernel_q`` (K, N)
  as its integers, transposed to (N, K) (int4 leaves are read as int8 and
  packed two per byte along K), and ``scale`` as float32.

Every parameter of the module must be found in the tree, with its shape;
leaves of the tree that the module does not hold (a decoder the port does
not run) are left out. A MaskGCT S2A holds ``cond_emb`` and ``sem_proj`` only
where the tree does: build it with `models/tts/maskgct/maskgct.
s2a_conditioning` of the tree's keys.

`init_like_flax` draws a module's parameters as the JAX modules' Flax
initializers do, walking the same scopes, so a port model trained from
scratch starts from the distribution the JAX trainer starts from (torch's
own defaults differ: ``nn.Linear`` draws uniform with variance
1/(3·fan_in) where Flax ``Dense`` draws lecun_normal, ``nn.Embedding``
draws std 1 where Flax ``Embed`` draws std 1/√features). JAX and torch
random streams differ, so the values are not JAX's, only their
distribution.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from amphion_tpu_torch.models.tts.maskgct.maskgct import MaskGCTS2A, MaskGCTT2S
from amphion_tpu_torch.models.vocoders.vocos import ConvNeXtBlock
from amphion_tpu_torch.modules.activations import Snake, SnakeBeta
from amphion_tpu_torch.modules.llama import AdaptiveRMSNorm, QDense, QDense4, RMSNorm
from amphion_tpu_torch.modules.quantize import FactorizedVectorQuantize, VectorQuantize
from amphion_tpu_torch.modules.weight_norm import (
    WNConv1d,
    WNConv2d,
    WNConvTranspose1d,
    WNLinear,
)
from amphion_tpu_torch.ops.kernels.int4_matmul import pack_int4


def _leaf(tree: dict, path: list[str], name: str, dtype=np.float32):
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            raise KeyError(f"{'.'.join(path)}: no scope {key!r} in the Flax tree")
        node = node[key]
    if name not in node:
        raise KeyError(f"{'.'.join(path)}: no leaf {name!r} in the Flax tree")
    return np.asarray(node[name]).astype(dtype)


def _weight_norm_scale(tree: dict, path: list[str]) -> np.ndarray:
    """The scale Flax's ``WeightNorm`` keeps for the conv at ``path``: the
    leaf ``"<name>/kernel/scale"`` of a ``WeightNorm_*`` scope beside it."""
    parent = tree
    for key in path[:-1]:
        parent = parent[key]
    leaf = f"{path[-1]}/kernel/scale"
    found = [k for k, v in parent.items()
             if k.startswith("WeightNorm_") and isinstance(v, dict) and leaf in v]
    if len(found) != 1:
        raise KeyError(f"{'.'.join(path)}: {len(found)} WeightNorm scopes hold {leaf!r} "
                       f"(want exactly one)")
    return _leaf(tree, path[:-1] + found, leaf)


def _flax_leaf(module: nn.Module, tree: dict, path: list[str], pname: str):
    """The Flax array for parameter ``pname`` of ``module``, in torch layout."""
    if isinstance(module, (WNConv1d, WNConv2d, WNConvTranspose1d, WNLinear)):
        if pname == "scale":
            return _weight_norm_scale(tree, path)
        if pname == "bias":
            return _leaf(tree, path, "bias")
        kernel = _leaf(tree, path, "kernel")  # (in, out), (k, in, out) or (kh, kw, in, out)
        if isinstance(module, WNLinear):
            return kernel.T
        if isinstance(module, WNConv2d):
            return kernel.transpose(3, 2, 0, 1)
        if isinstance(module, WNConv1d):
            return kernel.transpose(2, 1, 0)
        return kernel.transpose(1, 2, 0)[:, :, ::-1]
    if isinstance(module, (QDense, QDense4)):
        if pname == "scale":
            return _leaf(tree, path, "scale")
        w = np.ascontiguousarray(_leaf(tree, path, "kernel_q", np.int8).T)
        if isinstance(module, QDense4):
            return pack_int4(torch.from_numpy(w)).numpy()
        return w
    if isinstance(module, nn.Linear):
        if pname == "weight":
            return _leaf(tree, path, "kernel").T
        return _leaf(tree, path, "bias")
    if isinstance(module, nn.Conv1d):
        if pname == "weight":
            return _leaf(tree, path, "kernel").transpose(2, 1, 0)
        return _leaf(tree, path, "bias")
    if isinstance(module, nn.Conv2d):
        if pname == "weight":
            return _leaf(tree, path, "kernel").transpose(3, 2, 0, 1)
        return _leaf(tree, path, "bias")
    if isinstance(module, nn.LayerNorm):
        return _leaf(tree, path, "scale" if pname == "weight" else "bias")
    if isinstance(module, nn.Embedding):
        return _leaf(tree, path, "embedding")
    return _leaf(tree, path, pname)


@torch.no_grad()
def from_flax(module: nn.Module, tree: dict) -> nn.Module:
    """Copy the Flax parameter ``tree`` (nested dicts of arrays) into
    ``module`` in place, casting to each parameter's dtype; returns it."""
    for mname, sub in module.named_modules():
        path = mname.split(".") if mname else []
        tensors = list(sub.named_parameters(recurse=False))
        if isinstance(sub, (QDense, QDense4)):
            tensors += list(sub.named_buffers(recurse=False))
        for pname, param in tensors:
            arr = _flax_leaf(sub, tree, path, pname)
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{mname}.{pname}: Flax shape {arr.shape} "
                                 f"!= port shape {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return module


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """Flax's default kernel init: a normal truncated at ±2 standard
    deviations, rescaled to variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


@torch.no_grad()
def init_like_flax(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every parameter of ``module`` in place from the Flax
    initializer of its JAX counterpart; returns the module. ``generator``
    lives on the parameters' device.

    - Dense (``nn.Linear``): kernel lecun_normal (fan_in = in features),
      bias 0; the adaptive RMSNorm's ``to_weight`` kernel 0 and bias 1;
    - Conv (``nn.Conv1d``, ``nn.Conv2d``): kernel lecun_normal (fan_in =
      in/groups · k, or in · kh · kw), bias 0;
    - weight-normalised Dense, Conv and ConvTranspose: kernel
      lecun_normal (fan_in = in for a Dense, in/groups · k, or in/groups ·
      kh · kw, for a Conv and in · k for a ConvTranspose, as Flax counts
      it), bias 0, scale 1;
    - a Dense or Conv built with ``kernel_init=zeros`` in JAX (a flow's
      last projection), marked ``flax_zero_init``: kernel and bias 0;
    - a module with a ``flax_init_(generator)`` method (the relative
      attention's embeddings, a flow's affine, FastSpeech2's bins and
      Postnet's affine) draws its own parameters;
    - Snake and SnakeBeta: α (and β) 0 in log scale, else 1;
    - Embed (``nn.Embedding``): normal with std 1/√features;
    - LayerNorm and RMSNorm scales 1, LayerNorm bias 0;
    - VQ codebooks: ``FactorizedVectorQuantize`` normal(1),
      ``VectorQuantize`` uniform with variance 1/codebook_size;
    - MaskGCT's ``mask_emb``: normal with std 0.02;
    - a Vocos ConvNeXt block's ``gamma``: its layer scale.

    Buffers (quantized projections) are left alone; a parameter of any
    other kind raises."""
    done: set[int] = set()
    g = generator
    for name, sub in module.named_modules():
        own = dict(sub.named_parameters(recurse=False))
        if own and all(id(p) in done for p in own.values()):
            continue  # drawn by its parent (to_weight)
        if getattr(sub, "flax_zero_init", False):
            for p in own.values():
                nn.init.zeros_(p)
        elif hasattr(sub, "flax_init_"):
            sub.flax_init_(g)
        elif isinstance(sub, AdaptiveRMSNorm):
            nn.init.zeros_(sub.to_weight.weight)
            nn.init.ones_(sub.to_weight.bias)
            done.update(id(p) for p in sub.to_weight.parameters())
        elif isinstance(sub, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = sub.weight[0].numel()  # in (· k) per output
            _lecun_normal_(sub.weight, fan_in, g)
            if sub.bias is not None:
                nn.init.zeros_(sub.bias)
        elif isinstance(sub, (WNConv1d, WNConv2d, WNConvTranspose1d, WNLinear)):
            w = sub.weight  # (out, in(/g, k...)) or, transposed, (in, out, k)
            transposed = isinstance(sub, WNConvTranspose1d)
            fan_in = w.shape[0] * w.shape[2] if transposed else w[0].numel()
            _lecun_normal_(w, fan_in, g)
            nn.init.zeros_(sub.bias)
            nn.init.ones_(sub.scale)
        elif isinstance(sub, (Snake, SnakeBeta)):
            for p in own.values():
                nn.init.constant_(p, 0.0 if sub.alpha_logscale else 1.0)
        elif isinstance(sub, nn.Embedding):
            sub.weight.normal_(0.0, sub.embedding_dim ** -0.5, generator=g)
        elif isinstance(sub, nn.LayerNorm):
            nn.init.ones_(sub.weight)
            nn.init.zeros_(sub.bias)
        elif isinstance(sub, RMSNorm):
            nn.init.ones_(sub.scale)
        elif isinstance(sub, FactorizedVectorQuantize):
            sub.codebook.normal_(0.0, 1.0, generator=g)
        elif isinstance(sub, VectorQuantize):
            limit = (3.0 / sub.codebook.shape[0]) ** 0.5
            sub.codebook.uniform_(-limit, limit, generator=g)
        elif isinstance(sub, (MaskGCTT2S, MaskGCTS2A)):
            sub.mask_emb.normal_(0.0, 0.02, generator=g)
        elif isinstance(sub, ConvNeXtBlock):
            nn.init.constant_(sub.gamma, sub.layer_scale)
        else:
            if own:
                raise TypeError(f"init_like_flax: no Flax initializer known for "
                                f"{name or 'the module'} ({type(sub).__name__}: "
                                f"{sorted(own)})")
            continue
        done.update(id(p) for p in own.values())
    missed = [n for n, p in module.named_parameters() if id(p) not in done]
    if missed:
        raise TypeError(f"init_like_flax left {missed} undrawn")
    return module
