"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when no card is present and none was named, so a run
    never moves to the CPU without being asked to."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def strict_float32() -> None:
    """Make float32 work on the card compute in float32: TF32 off for cuDNN
    convolutions and for cuBLAS float32 products. PyTorch's default lets
    cuDNN round float32 convolutions through TF32, where the JAX reference
    computes them in float32. Every entry point and trainer of the port
    calls this before a model runs; a caller who wants TF32 sets
    ``torch.backends.cudnn.allow_tf32`` (and
    ``torch.backends.cuda.matmul.allow_tf32``) after it."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
