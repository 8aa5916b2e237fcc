"""Device and dtype resolution for every entry point of the port, and
the float32 scope its models run in on the card.

There is no fallback: ``device=None`` means the card, and a missing card
is an error. The CPU runs only when the caller names it."""

from __future__ import annotations

from contextlib import contextmanager

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


def _float32_knobs():
    """(object, attribute, value) of each setting :func:`ieee_float32`
    scopes. Torch with per-backend precision settings takes those; older
    torch the ``allow_tf32`` flags (mixing the two raises in new torch)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    conv = getattr(cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        knobs = [(conv, "fp32_precision", "ieee"), (matmul, "fp32_precision", "ieee")]
    else:
        knobs = [(cudnn, "allow_tf32", False), (matmul, "allow_tf32", False)]
    # the same shape picks the same algorithm, and that algorithm is
    # deterministic: split execution stays bit-equal to the unsplit model
    return knobs + [(cudnn, "benchmark", False), (cudnn, "deterministic", True)]


@contextmanager
def ieee_float32():
    """cuDNN convolutions and cuBLAS products in true float32 for the
    duration of the block, cuDNN's benchmark off and its algorithms
    deterministic; every setting is restored on exit. The CNNs enter it
    per convolution and GEMM, the LM once per forward pass."""
    knobs = _float32_knobs()
    saved = [getattr(obj, name) for obj, name, _ in knobs]
    try:
        for obj, name, value in knobs:
            setattr(obj, name, value)
        yield
    finally:
        for (obj, name, _), value in zip(knobs, saved):
            setattr(obj, name, value)
