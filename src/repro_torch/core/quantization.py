"""TFLite-style int8 post-training quantization (Jacob et al., CVPR'18).

The port's copy of the reference's ``core/quantization.py``, in the same
operation order so that every result is bit-equal to it on the same
inputs: ``q = clip(round(x / scale) + zp)`` in float32 (``torch.round``
rounds half to even, as ``jnp.round`` does), a scale of 1 for an all-zero
range, int8 storage.

* affine per-tensor / per-channel quantization (:func:`quantize`),
* weight-set quantization of a nested dict / list / tuple of tensors
  (per-output-channel for matmul and conv kernels, float otherwise),
* the activation wire format of the split boundary
  (:func:`encode_activation` / :func:`decode_activation`),
* fake-quant for accuracy studies.

The int8 GEMMs that consume these tensors live in
``repro_torch.kernels.quant_matmul``. Every function runs on the device
of the tensor it is given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

INT8_MIN, INT8_MAX = -128, 127

__all__ = ["INT8_MAX", "INT8_MIN", "QTensor", "decode_activation",
           "dequantize_params", "encode_activation", "fake_quant",
           "param_bytes", "quantize", "quantize_params"]


@dataclass(frozen=True)
class QTensor:
    """An int8-quantized tensor: ``x ~= (values - zero_point) * scale``."""

    values: torch.Tensor  # int8
    scale: torch.Tensor  # float32, scalar or per-axis
    zero_point: torch.Tensor  # int32, same shape as scale
    axis: int | None = None  # quantization axis (None = per-tensor)

    @property
    def nbytes(self) -> int:
        """Wire size: int8 payload (scale/zp are negligible header)."""
        return int(self.values.numel())

    def dequantize(self) -> torch.Tensor:
        scale, zp = self.scale, self.zero_point
        if self.axis is not None:
            shape = [1] * self.values.dim()
            shape[self.axis] = -1
            scale = scale.reshape(shape)
            zp = zp.reshape(shape)
        return (self.values.float() - zp.float()) * scale


def true_divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device, as the reference
    divides. On a CUDA tensor, ``x / <Python number>`` multiplies by the
    number's reciprocal, which can differ from the quotient in the last
    bit; a divisor held in a tensor on x's device is divided by."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _affine_params(x_min: torch.Tensor, x_max: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scale/zero-point for asymmetric int8 covering [x_min, x_max]."""
    x_min = torch.clamp(x_min, max=0.0)
    x_max = torch.clamp(x_max, min=0.0)
    scale = true_divide(x_max - x_min, float(INT8_MAX - INT8_MIN))
    scale = torch.where(scale <= 0, 1.0, scale)
    zp = torch.clamp(torch.round(INT8_MIN - x_min / scale), INT8_MIN,
                     INT8_MAX).to(torch.int32)
    return scale.float(), zp


def quantize(x: torch.Tensor, axis: int | None = None,
             symmetric: bool = False) -> QTensor:
    """Quantize to int8. ``axis`` selects per-channel scales (weights);
    ``symmetric`` forces zero_point = 0 (TFLite weight convention)."""
    x = x.float()
    if axis is None:
        x_min, x_max = x.min(), x.max()
    else:
        reduce_dims = tuple(i for i in range(x.dim()) if i != axis)
        if reduce_dims:
            x_min, x_max = x.amin(dim=reduce_dims), x.amax(dim=reduce_dims)
        else:  # a 1-D per-element "channel": nothing to reduce
            x_min, x_max = x, x
    if symmetric:
        amax = torch.maximum(x_min.abs(), x_max.abs())
        scale = torch.where(amax <= 0, 1.0, true_divide(amax, INT8_MAX)).float()
        zp = torch.zeros_like(scale, dtype=torch.int32)
    else:
        scale, zp = _affine_params(x_min, x_max)
    if axis is not None:
        shape = [1] * x.dim()
        shape[axis] = -1
        s_b, z_b = scale.reshape(shape), zp.reshape(shape)
    else:
        s_b, z_b = scale, zp
    q = torch.clamp(torch.round(x / s_b) + z_b, INT8_MIN, INT8_MAX).to(torch.int8)
    return QTensor(values=q, scale=scale, zero_point=zp, axis=axis)


def fake_quant(x: torch.Tensor, axis: int | None = None,
               symmetric: bool = False) -> torch.Tensor:
    """Quantize-dequantize round trip (accuracy-degradation studies)."""
    return quantize(x, axis=axis, symmetric=symmetric).dequantize().to(x.dtype)


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` on every leaf of nested dicts, lists and tuples; a
    :class:`QTensor` is a leaf."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def quantize_params(params: Any, channel_axis_rank: int = 2) -> Any:
    """Quantize every float leaf of a params tree.

    Leaves with rank >= ``channel_axis_rank`` (matmul/conv kernels) use
    symmetric per-output-channel scales (last axis, the TFLite
    convention); vectors (biases, norm scales) stay float32 — TFLite keeps
    biases int32 at scale_in*scale_w, which round-trips exactly, so f32 is
    the faithful storage-equivalent here."""

    def quant_leaf(x):
        if not isinstance(x, torch.Tensor) or not x.is_floating_point():
            return x
        if x.dim() >= channel_axis_rank:
            return quantize(x, axis=x.dim() - 1, symmetric=True)
        return x

    return _tree_map(quant_leaf, params)


def dequantize_params(params: Any) -> Any:
    return _tree_map(lambda x: x.dequantize() if isinstance(x, QTensor) else x,
                     params)


def param_bytes(params: Any) -> int:
    """Deployed size of a (possibly quantized) params tree in bytes."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            total += leaf.nbytes + leaf.scale.numel() * 4 + leaf.zero_point.numel() * 4
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total


# ---------------------------------------------------------------------------
# Wire format for split-boundary activations
# ---------------------------------------------------------------------------


def encode_activation(x: torch.Tensor) -> QTensor:
    """Quantize an intermediate activation for transmission (per-tensor
    asymmetric — the TFLite activation convention)."""
    return quantize(x, axis=None, symmetric=False)


def decode_activation(qt: QTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return qt.dequantize().to(dtype)
