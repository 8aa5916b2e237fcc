"""Device and dtype resolution for every entry point of the port.

There is no fallback: ``device=None`` means the card, and a missing card
is an error. The CPU runs only when the caller names it."""

from __future__ import annotations

import torch

#: Floating types the DP kernels are compiled for.
DTYPES = (torch.float32, torch.float64)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` for a CUDA device
    when ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card found (torch.cuda.is_available() is False); "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def resolve_dtype(dtype: torch.dtype) -> torch.dtype:
    """The DP's floating type: ``torch.float32`` or ``torch.float64``."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"got {dtype}")
    return dtype
