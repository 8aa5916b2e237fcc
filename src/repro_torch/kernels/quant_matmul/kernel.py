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
device. :func:`w8a8_prep_mirror` computes the W8A8 pre-pass (w transposed
and its column sums) as the kernel does, for tests. The TPU kernel's tiling arguments (``block_m/n/k``) are not part
of these signatures: the CUDA kernels pick their own tiles.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, holds_no_data, note_kernel
from repro_torch.kernels.quant_matmul.ref import int_matmul

__all__ = ["OUT_DTYPES", "W8A16_LAUNCHES", "W8A8_LAUNCHES", "W8A8_VARIANTS",
           "W8A8_WGMMA_LAUNCHES", "X_DTYPES",
           "quant_matmul_kernel", "quant_matmul_plain", "reset_launch_counts",
           "split_bf16", "w8a16_matmul_kernel", "w8a16_matmul_plain", "w8a8_prep_mirror"]

# Kernel launches since the last reset_launch_counts(); bumped only where
# a kernel is launched, never by a plain version.
W8A8_LAUNCHES = 0
W8A8_WGMMA_LAUNCHES = 0
W8A16_LAUNCHES = 0

W8A8_VARIANTS = ("wgmma", "mma")

OUT_DTYPES = (torch.float32, torch.bfloat16)
X_DTYPES = (torch.float32, torch.bfloat16)  # W8A16 activations


def reset_launch_counts() -> None:
    global W8A8_LAUNCHES, W8A8_WGMMA_LAUNCHES, W8A16_LAUNCHES
    W8A8_LAUNCHES = W8A8_WGMMA_LAUNCHES = W8A16_LAUNCHES = 0


def _variant(K: int, a_ptr: int) -> str:
    """The W8A8 kernel ``quant_matmul_w8a8`` runs for a reduction depth K
    and an activation tensor at address ``a_ptr`` (its C twin is
    ``quant_matmul_w8a8_variant``): the wgmma kernel where TMA can read a's
    rows (K % 16 == 0, a 16-byte aligned), the mma.sync kernel otherwise."""
    return "wgmma" if K % 16 == 0 and a_ptr % 16 == 0 else "mma"


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


# k rows per block of the pre-pass in csrc/quant_matmul.cu: each block adds
# its column sums to the total once
PREP_KSPLIT = 512


def _byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """CUDA's ``__byte_perm(x, y, sel)`` on int64 tensors of 32-bit words:
    byte i of the result is byte ``(sel >> 4 i) & 7`` of the eight bytes
    of x (bytes 0-3) and y (bytes 4-7)."""
    src = (y << 32) | x
    out = torch.zeros_like(x)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        out |= ((src >> (8 * b)) & 0xFF) << (8 * i)
    return out


def w8a8_prep_mirror(w_q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The W8A8 pre-pass's arithmetic (``w8a8_prep_kernel``) in PyTorch,
    for tests: ``(wT, colsum)`` of int8 w (K, N). Rows of four columns are
    read as little-endian words, each 4 x 4-byte block (four k rows of one
    word) is transposed with the kernel's byte permutes into words of four
    consecutive k of one column, and each column's words are summed as
    signed bytes (``__dp4a`` against 0x01010101) per block of
    ``PREP_KSPLIT`` k rows; the blocks' sums are then added, as the
    kernel's atomic adds do. wT (N, K) is read back from the transposed
    words. Runs on any device and launches nothing."""
    K, N = w_q.shape
    Kp, Np = -(-K // PREP_KSPLIT) * PREP_KSPLIT, -(-N // 4) * 4
    wp = torch.nn.functional.pad(w_q, (0, Np - N, 0, Kp - K))
    words = wp.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF  # (Kp, Np / 4)
    r = words.reshape(Kp // 4, 4, Np // 4)  # [k quad][row q of the quad][column quad]
    t0, t1 = _byte_perm(r[:, 0], r[:, 1], 0x5140), _byte_perm(r[:, 0], r[:, 1], 0x7362)
    t2, t3 = _byte_perm(r[:, 2], r[:, 3], 0x5140), _byte_perm(r[:, 2], r[:, 3], 0x7362)
    d = torch.stack([_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
                     _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)], -1)
    d = d.reshape(Kp // 4, Np)  # [k quad][column]: four k of one column
    sbytes = torch.stack([((d >> (8 * i)) & 0xFF) for i in range(4)], -1)
    sbytes = torch.where(sbytes >= 128, sbytes - 256, sbytes)  # (Kp / 4, Np, 4) signed
    per_block = sbytes.sum(-1).reshape(Kp // PREP_KSPLIT, PREP_KSPLIT // 4, Np).sum(1)
    colsum = per_block.sum(0)[:N].to(torch.int32)
    wT = sbytes.permute(1, 0, 2).reshape(Np, Kp)[:N, :K].to(torch.int8)
    return wT.contiguous(), colsum


def quant_matmul_kernel(a_q, w_q, a_scale, a_zp, w_scale, *, out_dtype=torch.float32,
                        variant: str | None = None):
    """Launch the W8A8 kernel: ``a_q`` int8 (M, K), ``w_q`` int8 (K, N),
    ``a_scale`` float32 and ``a_zp`` int32 of one element each (read on
    the card: no host sync), ``w_scale`` float32 (N,); contiguous CUDA
    tensors on one card. Returns (M, N) in ``out_dtype``. ``variant`` None
    takes :func:`_variant`'s kernel; ``"mma"`` forces the mma.sync kernel
    (any K; for timing and tests); ``"wgmma"`` is refused where
    :func:`_variant` would not pick it. Allocates int32 column sums and,
    for the wgmma kernel, w transposed (N, K). Raises if the kernel cannot
    be built or launched. Inputs that hold no data get an empty output
    (and the same scratch, so a trace's live bytes match the card's)."""
    global W8A8_LAUNCHES, W8A8_WGMMA_LAUNCHES
    M, K, N = _check_gemm("quant_matmul_kernel", a_q, w_q, w_scale, (torch.int8,),
                          out_dtype)
    if a_scale.dtype != torch.float32 or a_scale.numel() != 1 \
            or a_zp.dtype != torch.int32 or a_zp.numel() != 1:
        raise ValueError("quant_matmul_kernel: a_scale must be one float32 and "
                         f"a_zp one int32, got {a_scale.dtype} x{a_scale.numel()} "
                         f"and {a_zp.dtype} x{a_zp.numel()}")
    if holds_no_data(a_q):
        dev = a_q.device
        out = torch.empty((M, N), dtype=out_dtype, device=dev)
        scratch = [torch.empty((N,), dtype=torch.int32, device=dev)]
        if _variant(K, 0) == "wgmma":
            scratch.append(torch.empty((N, K), dtype=torch.int8, device=dev))
        note_kernel("quant_matmul", (a_q, w_q, a_scale, a_zp, w_scale), out)
        return out
    dev = build.check_cuda("quant_matmul_kernel", a_q=a_q, w_q=w_q, a_scale=a_scale,
                      a_zp=a_zp, w_scale=w_scale)
    chosen = _variant(K, a_q.data_ptr())
    if variant not in (None, *W8A8_VARIANTS) or (variant == "wgmma" and chosen != "wgmma"):
        raise ValueError(f"quant_matmul_kernel: variant {variant!r} cannot run K {K} "
                         f"(it takes {chosen!r})")
    chosen = variant or chosen
    built = build.load("quant_matmul.cu")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    colsum = torch.empty((N,), dtype=torch.int32, device=dev)
    args = (a_q.data_ptr(), w_q.data_ptr(), a_scale.data_ptr(), a_zp.data_ptr(),
            w_scale.data_ptr(), colsum.data_ptr())
    tail = (M, K, N, int(out_dtype == torch.bfloat16))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if chosen == "wgmma":
            w_t = torch.empty((N, K), dtype=torch.int8, device=dev)
            code = built.lib.quant_matmul_w8a8(*args, w_t.data_ptr(), out.data_ptr(), *tail,
                                               stream)
        else:
            code = built.lib.quant_matmul_w8a8_mma(*args, out.data_ptr(), *tail, stream)
    build.check_launch(built, code, f"quant_matmul_w8a8 ({chosen})")
    W8A8_LAUNCHES += 1
    W8A8_WGMMA_LAUNCHES += int(chosen == "wgmma")
    note_kernel("quant_matmul", (a_q, w_q, a_scale, a_zp, w_scale), out)
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
    built or launched. Inputs that hold no data get an empty output."""
    global W8A16_LAUNCHES
    M, K, N = _check_gemm("w8a16_matmul_kernel", x, w_q, w_scale, X_DTYPES, out_dtype)
    if holds_no_data(x):
        out = torch.empty((M, N), dtype=out_dtype, device=x.device)
        note_kernel("w8a16_matmul", (x, w_q, w_scale), out)
        return out
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
    note_kernel("w8a16_matmul", (x, w_q, w_scale), out)
    return out
