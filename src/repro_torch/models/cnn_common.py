"""Shared conv primitives for the paper's CNN models (inference path).

The port's copy of the reference's ``models/cnn_common.py``. BatchNorm is
folded into per-channel (scale, bias) applied after the conv, as a
separate multiply and add (the deployed TFLite-int8 graph form the paper
benchmarks). Activations keep the reference's NHWC shapes.

Layout: a contiguous NHWC activation, permuted to (N, C, H, W), is an
NCHW view in channels-last memory, which ``F.conv2d`` takes without a
copy. Conv weights are held as OIHW in channels-last memory (OHWI bytes),
converted once from the reference's HWIO (:func:`conv_weight`); a
depthwise weight ``(k, k, 1, C)`` becomes ``(C, 1, k, k)`` with
``groups=C``. Dense weights stay ``(d_in, d_out)``.

On the card every convolution and product runs in IEEE float32 (no TF32)
with cuDNN's benchmark off, scoped to the call (:func:`ieee_float32`): the
caller's process-wide settings are restored after it.
"""

from __future__ import annotations

import math
from contextlib import nullcontext

import torch
import torch.nn.functional as F

from repro_torch.device import ieee_float32

__all__ = ["conv2d", "conv_weight", "dense", "global_avg_pool", "ieee_float32",
           "init_conv", "init_dense", "max_pool"]


def _scope(x: torch.Tensor):
    return ieee_float32() if x.is_cuda else nullcontext()


def conv_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """The reference's HWIO kernel (depthwise: ``(k, k, 1, C)``) as OIHW
    in channels-last memory (depthwise: ``(C, 1, k, k)``)."""
    return w_hwio.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def init_conv(generator: torch.Generator, k: int, c_in: int, c_out: int,
              depthwise: bool = False, device=None) -> dict:
    """He-normal conv weights drawn on the CPU from ``generator`` in HWIO
    order (the reference's shape), then moved to ``device``."""
    if depthwise:
        shape = (k, k, 1, c_in)  # HWIO with groups = c_in
        fan_in = k * k
    else:
        shape = (k, k, c_in, c_out)
        fan_in = k * k * c_in
    w = torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)
    c = c_out if not depthwise else c_in
    return {"w": conv_weight(w).to(device), "scale": torch.ones(c, device=device),
            "bias": torch.zeros(c, device=device)}


def conv2d(p: dict, x: torch.Tensor, stride: int = 1, depthwise: bool = False,
           act: str = "relu6") -> torch.Tensor:
    """NHWC conv with the reference's padding ``((k-1)//2, k//2)`` per
    spatial side (an even k pads with ``F.pad``), then scale and bias."""
    k = p["w"].shape[-1]
    lo, hi = (k - 1) // 2, k // 2
    xc = x.permute(0, 3, 1, 2)
    if lo != hi:
        xc, lo = F.pad(xc, (lo, hi, lo, hi)), 0
    with _scope(x):
        y = F.conv2d(xc, p["w"], stride=stride, padding=lo,
                     groups=x.shape[-1] if depthwise else 1)
    y = y.permute(0, 2, 3, 1) * p["scale"] + p["bias"]
    if act == "relu6":
        y = torch.clamp(y, 0.0, 6.0)
    elif act == "relu":
        y = torch.relu(y)
    return y


def max_pool(x: torch.Tensor, k: int = 3, stride: int = 2) -> torch.Tensor:
    """NHWC max pool, padded with -inf by ``((k-1)//2, k//2)``."""
    lo, hi = (k - 1) // 2, k // 2
    xc = x.permute(0, 3, 1, 2)
    if lo != hi:
        xc, lo = F.pad(xc, (lo, hi, lo, hi), value=-math.inf), 0
    return F.max_pool2d(xc, k, stride, padding=lo).permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=(1, 2))


def init_dense(generator: torch.Generator, d_in: int, d_out: int, device=None) -> dict:
    w = torch.randn((d_in, d_out), generator=generator) / math.sqrt(d_in)
    return {"w": w.to(device), "b": torch.zeros(d_out, device=device)}


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    with _scope(x):
        return x @ p["w"] + p["b"]
