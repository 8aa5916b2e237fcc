"""Plain PyTorch oracles for the int8 GEMMs, the port's copies of the
reference's ``kernels/quant_matmul/ref.py``.

``torch.matmul`` of int32 tensors is refused on the card, so the exact
int32 accumulator is formed as a float64 product of the int8 values and
cast back: every partial sum is an integer of magnitude at most
K * 2^14 < 2^53, which float64 holds exactly."""

from __future__ import annotations

import torch

__all__ = ["float_matmul_ref", "int_matmul", "quant_matmul_ref", "w8a16_matmul_ref"]


def int_matmul(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 (M, K) and int8 (K, N)."""
    return (a_q.double() @ w_q.double()).to(torch.int32)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device).to(torch.float32)


def quant_matmul_ref(a_q, w_q, a_scale, a_zp, w_scale, out_dtype=torch.float32):
    """Exact integer-arithmetic reference (Jacob et al. CVPR'18 semantics):
    the zero-point correction is subtracted in int32, then one rounding
    to float32."""
    acc = int_matmul(a_q, w_q)
    colsum = w_q.sum(0, dtype=torch.int32)
    corr = torch.as_tensor(a_zp, device=a_q.device).to(torch.int32) * colsum[None, :]
    deq = (acc - corr).float() * _f32(a_scale, a_q) * _f32(w_scale, a_q)[None, :]
    return deq.to(out_dtype)


def float_matmul_ref(a_q, w_q, a_scale, a_zp, w_scale):
    """Dequantize-then-matmul reference (same math, float order)."""
    a = (a_q.float() - _f32(a_zp, a_q)) * _f32(a_scale, a_q)
    w = w_q.float() * _f32(w_scale, a_q)[None, :]
    return a @ w


def w8a16_matmul_ref(x, w_q, w_scale):
    """Weight-only dequantize-then-matmul reference."""
    w = w_q.float() * _f32(w_scale, w_q)[None, :]
    return x.float() @ w
