"""Public ops: quantized linear layers on the int8 GEMM kernels.

The port of the reference's ``kernels/quant_matmul/ops.py``. Its
``interpret`` switch gives way to the tensors' device: CPU tensors run the
kernels' plain PyTorch versions, CUDA tensors launch the kernels
(``csrc/quant_matmul.cu``) or raise; tensors that hold no data
(``meta``, ``FakeTensorMode``) get the kernel's empty output. ``quant_linear`` is the layer-level
convenience that quantizes activations on the fly against int8 weights
(the deployed TinyML segment hot path)."""

from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor, quantize
from repro_torch.kernels import holds_no_data
from repro_torch.kernels.quant_matmul.kernel import (
    quant_matmul_kernel,
    quant_matmul_plain,
    w8a16_matmul_kernel,
    w8a16_matmul_plain,
)
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

__all__ = ["quant_linear", "quant_matmul", "w8a16_linear", "w8a16_matmul"]


def quant_matmul(a_q, w_q, a_scale, a_zp, w_scale, *, out_dtype=torch.float32):
    """(M,K) int8 x (K,N) int8 -> (M,N) ``out_dtype``. ``a_scale`` and
    ``a_zp`` may be numbers or one-element tensors."""
    dev = a_q.device
    a_scale = torch.as_tensor(a_scale, device=dev).to(torch.float32).reshape(1)
    a_zp = torch.as_tensor(a_zp, device=dev).to(torch.int32).reshape(1)
    a_q, w_q = a_q.contiguous(), w_q.contiguous()
    w_scale = w_scale.to(torch.float32).contiguous()
    if dev.type == "cpu" and not holds_no_data(a_q):
        return quant_matmul_plain(a_q, w_q, a_scale, a_zp, w_scale, out_dtype=out_dtype)
    return quant_matmul_kernel(a_q, w_q, a_scale, a_zp, w_scale, out_dtype=out_dtype)


def w8a16_matmul(x, w_q, w_scale, *, out_dtype=torch.float32):
    """(M,K) float32/bfloat16 x (K,N) int8 -> (M,N) ``out_dtype``."""
    x, w_q = x.contiguous(), w_q.contiguous()
    w_scale = w_scale.to(torch.float32).contiguous()
    if x.device.type == "cpu" and not holds_no_data(x):
        return w8a16_matmul_plain(x, w_q, w_scale, out_dtype=out_dtype)
    return w8a16_matmul_kernel(x, w_q, w_scale, out_dtype=out_dtype)


def _column_scales(w: QTensor) -> torch.Tensor:
    if w.axis not in (1, None):
        raise ValueError(f"weights must be per-output-channel (axis 1) or "
                         f"per-tensor, got axis {w.axis}")
    if w.axis == 1:
        return w.scale
    return w.scale.reshape(()).expand(w.values.shape[1])


def quant_linear(x: torch.Tensor, w: QTensor, *, use_kernel: bool = True) -> torch.Tensor:
    """x: (..., K) float; w: QTensor (K, N) int8 per-channel (axis=1).

    Quantizes activations per-tensor (asymmetric, TFLite convention) and
    runs the int8 GEMM; ``use_kernel=False`` runs the integer reference
    (``quant_matmul_ref``) instead."""
    w_scale = _column_scales(w)
    batch_shape = x.shape[:-1]
    K = x.shape[-1]
    xa = quantize(x.reshape(-1, K), axis=None, symmetric=False)
    if use_kernel:
        out = quant_matmul(xa.values, w.values, xa.scale, xa.zero_point, w_scale)
    else:
        out = quant_matmul_ref(xa.values, w.values, xa.scale, xa.zero_point, w_scale)
    return out.reshape(*batch_shape, -1).to(x.dtype)


def w8a16_linear(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Weight-only quantized linear: float activations x int8 weights.
    w: QTensor (K, N), per-output-channel symmetric."""
    w_scale = _column_scales(w)
    batch_shape = x.shape[:-1]
    K = x.shape[-1]
    out = w8a16_matmul(x.reshape(-1, K), w.values, w_scale)
    return out.reshape(*batch_shape, -1).to(x.dtype)
