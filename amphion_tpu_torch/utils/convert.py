"""Weight bridge: load a JAX/Flax parameter tree into a port module.

The port names its submodules after the Flax scopes, so one walk over the
module's parameters finds each one's leaf in the tree by its dotted path
(``diff_estimator.encoder.layer_3.attn.q_proj`` → ``tree["diff_estimator"]
["encoder"]["layer_3"]["attn"]["q_proj"]``) and converts the layout:

- Linear ``kernel`` (in, out) → ``weight`` (out, in); ``bias`` as is;
- Conv1d ``kernel`` (k, in/groups, out) → ``weight`` (out, in/groups, k);
- LayerNorm ``scale`` → ``weight``; Embedding ``embedding`` → ``weight``;
- any other parameter (RMSNorm ``scale``, ConvNeXt ``gamma``, a VQ
  ``codebook``) carries over under its own name;
- a quantized projection (`QDense`, `QDense4`) takes ``kernel_q`` (K, N)
  as its integers, transposed to (N, K) (int4 leaves are read as int8 and
  packed two per byte along K), and ``scale`` as float32.

Every parameter of the module must be found in the tree, with its shape;
leaves of the tree that the module does not hold (a decoder the port does
not run) are left out.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from amphion_tpu_torch.modules.llama import QDense, QDense4
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


def _flax_leaf(module: nn.Module, tree: dict, path: list[str], pname: str):
    """The Flax array for parameter ``pname`` of ``module``, in torch layout."""
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
