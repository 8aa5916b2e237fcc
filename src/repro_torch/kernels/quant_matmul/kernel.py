"""The int8 GEMM kernels (``csrc/quant_matmul.cu``): wrappers, launch
counts and the plain PyTorch version of each kernel's own arithmetic.

* :func:`quant_matmul_kernel` (W8A8) replaces the reference's
  ``_qmm_kernel``: int8 (M, K) x int8 (K, N) accumulated exactly in int32,
  then the float32 epilogue ``fma(-a_zp, colsum[n], f32(acc)) * a_scale *
  w_scale[n]``, cast to ``out_dtype`` (float32 or bfloat16, nearest-even).
  The subtraction is one fused multiply-add, rounded once, because that
  is what the reference kernel computes: XLA contracts its ``acc - a_zp *
  colsum`` into an FMA. Where ``|acc| > 2^24`` this differs from
  ``quant_matmul_ref``, which subtracts in int32 before its one rounding.
* :func:`w8a16_matmul_kernel` (weight-only int8) replaces
  ``_w8a16_kernel``: the float32 sum over K of ``float(x) * float(w)``,
  then ``acc * w_scale[n]`` once in the epilogue. The kernel forms every
  product exactly on the bf16 tensor cores: int8 w is exact in bf16, and
  float32 x is split into the bf16 pieces :func:`split_bf16` gives, whose
  sum is x; only the order of the float32 sum differs.

A ``*_kernel`` function launches its kernel on CUDA tensors and raises on
anything else; the ``*_plain`` functions compute the same function with
PyTorch on any device. ``ops.py`` picks between them by the tensors'
device. The TPU kernel's tiling arguments (``block_m/n/k``) are not part
of these signatures: the CUDA kernels pick their own tiles.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quant_matmul.ref import int_matmul

__all__ = ["OUT_DTYPES", "W8A16_LAUNCHES", "W8A8_LAUNCHES", "X_DTYPES",
           "quant_matmul_kernel", "quant_matmul_plain", "reset_launch_counts",
           "split_bf16", "w8a16_matmul_kernel", "w8a16_matmul_plain"]

# Kernel launches since the last reset_launch_counts(); bumped only where
# a kernel is launched, never by a plain version.
W8A8_LAUNCHES = 0
W8A16_LAUNCHES = 0

OUT_DTYPES = (torch.float32, torch.bfloat16)
X_DTYPES = (torch.float32, torch.bfloat16)  # W8A16 activations


def reset_launch_counts() -> None:
    global W8A8_LAUNCHES, W8A16_LAUNCHES
    W8A8_LAUNCHES = W8A16_LAUNCHES = 0


def _check_gemm(name, a, w_q, w_scale, a_dtypes, out_dtype) -> tuple[int, int, int]:
    if a.dim() != 2 or w_q.dim() != 2 or a.shape[1] != w_q.shape[0]:
        raise ValueError(f"{name}: needs (M, K) x (K, N), got {tuple(a.shape)} "
                         f"x {tuple(w_q.shape)}")
    M, K = a.shape
    N = w_q.shape[1]
    if min(M, K, N) < 1:
        raise ValueError(f"{name}: empty product {M} x {K} x {N}")
    if a.dtype not in a_dtypes or w_q.dtype != torch.int8:
        raise ValueError(f"{name}: operands must be {', '.join(map(str, a_dtypes))} "
                         f"and int8, got {a.dtype} and {w_q.dtype}")
    if w_scale.dtype != torch.float32 or tuple(w_scale.shape) != (N,):
        raise ValueError(f"{name}: w_scale must be float32 ({N},), got "
                         f"{w_scale.dtype} {tuple(w_scale.shape)}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16, got {out_dtype}")
    return M, K, N


def quant_matmul_plain(a_q, w_q, a_scale, a_zp, w_scale, *, out_dtype=torch.float32):
    """The W8A8 kernel's function in PyTorch: exact int32 ``acc``, then
    ``f32(f64(f32(acc)) - f64(a_zp) * f64(f32(colsum)))`` (the exact value
    of ``acc - a_zp * colsum`` in float64, rounded once: one FMA), then
    ``* a_scale``, then ``* w_scale[n]``, each rounded to float32."""
    _check_gemm("quant_matmul_plain", a_q, w_q, w_scale, (torch.int8,), out_dtype)
    acc = int_matmul(a_q, w_q).float()
    colsum = w_q.sum(0, dtype=torch.int32).float()
    zp = a_zp.reshape(()).double()
    t = (acc.double() - zp * colsum.double()[None, :]).float()
    t = t * a_scale.reshape(()).float()
    t = t * w_scale[None, :]
    return t.to(out_dtype)


def quant_matmul_kernel(a_q, w_q, a_scale, a_zp, w_scale, *, out_dtype=torch.float32):
    """Launch the W8A8 kernel: ``a_q`` int8 (M, K), ``w_q`` int8 (K, N),
    ``a_scale`` float32 and ``a_zp`` int32 of one element each (read on
    the card: no host sync), ``w_scale`` float32 (N,); contiguous CUDA
    tensors on one card. Returns (M, N) in ``out_dtype``. Raises if the
    kernel cannot be built or launched."""
    global W8A8_LAUNCHES
    M, K, N = _check_gemm("quant_matmul_kernel", a_q, w_q, w_scale, (torch.int8,),
                          out_dtype)
    if a_scale.dtype != torch.float32 or a_scale.numel() != 1 \
            or a_zp.dtype != torch.int32 or a_zp.numel() != 1:
        raise ValueError("quant_matmul_kernel: a_scale must be one float32 and "
                         f"a_zp one int32, got {a_scale.dtype} x{a_scale.numel()} "
                         f"and {a_zp.dtype} x{a_zp.numel()}")
    dev = build.check_cuda("quant_matmul_kernel", a_q=a_q, w_q=w_q, a_scale=a_scale,
                      a_zp=a_zp, w_scale=w_scale)
    built = build.load("quant_matmul.cu")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    colsum = torch.empty((N,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = built.lib.quant_matmul_w8a8(
            a_q.data_ptr(), w_q.data_ptr(), a_scale.data_ptr(), a_zp.data_ptr(),
            w_scale.data_ptr(), colsum.data_ptr(), out.data_ptr(), M, K, N,
            int(out_dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(built, code, "quant_matmul_w8a8")
    W8A8_LAUNCHES += 1
    return out


def split_bf16(x: torch.Tensor, pieces: int = 3) -> list[torch.Tensor]:
    """The W8A16 kernel's bf16 pieces of x: ``x1 = bf16(x)``, ``x2 =
    bf16(x - x1)``, ``x3 = bf16(x - x1 - x2)`` (nearest even; each
    difference is exact in float32). For float32 x the three sum to x
    exactly for 0 and for every |x| from 2^-110 up to bf16's largest
    finite value (3.3895e38): bf16 has float32's exponent range, and three
    8-bit significands cover 24 bits (below 2^-110 the last piece would
    need bf16 subnormals finer than 2^-133). bfloat16 x is its own single
    piece."""
    rest = x.float()
    out = []
    for _ in range(pieces):
        piece = rest.to(torch.bfloat16)
        out.append(piece)
        rest = rest - piece.float()
    return out


def w8a16_matmul_plain(x, w_q, w_scale, *, out_dtype=torch.float32):
    """The W8A16 kernel's function in PyTorch: a float32 product of
    ``float(x)`` and ``float(w)``, then ``* w_scale[n]`` once."""
    _check_gemm("w8a16_matmul_plain", x, w_q, w_scale, X_DTYPES, out_dtype)
    return ((x.float() @ w_q.float()) * w_scale[None, :]).to(out_dtype)


def w8a16_matmul_kernel(x, w_q, w_scale, *, out_dtype=torch.float32):
    """Launch the W8A16 kernel: ``x`` float32 or bfloat16 (M, K), ``w_q``
    int8 (K, N), ``w_scale`` float32 (N,); contiguous CUDA tensors on one
    card. Returns (M, N) in ``out_dtype``. Raises if the kernel cannot be
    built or launched."""
    global W8A16_LAUNCHES
    M, K, N = _check_gemm("w8a16_matmul_kernel", x, w_q, w_scale, X_DTYPES, out_dtype)
    dev = build.check_cuda("w8a16_matmul_kernel", x=x, w_q=w_q, w_scale=w_scale)
    built = build.load("quant_matmul.cu")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        code = built.lib.quant_matmul_w8a16(
            x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), out.data_ptr(), M, K, N,
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(built, code, "quant_matmul_w8a16")
    W8A16_LAUNCHES += 1
    return out
