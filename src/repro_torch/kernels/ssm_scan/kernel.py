"""The chunked SSD scan kernels (``csrc/ssm_scan.cu``): their wrapper,
launch count, chunked plain PyTorch version and a mirror of the kernels'
arithmetic.

:func:`ssm_scan_kernel` replaces the reference's ``_ssd_kernel``
(``kernels/ssm_scan/kernel.py``) and launches the CUDA kernels on CUDA
tensors, raising on anything else: one C entry runs three kernels (chunk
states, state passing, outputs), and :data:`SSD_LAUNCHES` counts one per
call. :func:`ssm_scan_plain` computes the same function with PyTorch on
any device, chunk by chunk with the TPU kernel's arithmetic: float32,
``-inf`` above the diagonal before ``exp``, a zero state at the first
chunk and a ragged tail zero-padded. B and C may be shared by groups of
heads: ``b``/``c`` of (BG, S, ds) serve sequence ``bh`` from row
``bh // (BH // BG)``, as the flash kernel maps kv heads; BG = BH is the
reference's layout. :func:`ssm_scan_pieces` computes the function as the
kernels do, for tests: three passes, products of exact bf16 pieces.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, holds_no_data, note_kernel

__all__ = ["MAX_CHUNK", "MAX_DS", "MAX_PH", "SSD_LAUNCHES", "X_DTYPES",
           "reset_launch_count", "ssm_scan_kernel", "ssm_scan_pieces", "ssm_scan_plain"]

# Calls that launched the kernels since the last reset_launch_count(); bumped
# only where they are launched, never by the plain version.
SSD_LAUNCHES = 0

# What the kernel is compiled for: chunk rows, head dim, state size. Checked
# here only: csrc/ssm_scan.cu takes them as given.
MAX_CHUNK, MAX_PH, MAX_DS = 128, 64, 128

X_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_count() -> None:
    global SSD_LAUNCHES
    SSD_LAUNCHES = 0


def _check(x, b, c, dA, dt, chunk) -> tuple[int, int, int, int, int, int]:
    if x.dim() != 3 or b.dim() != 3 or b.shape != c.shape:
        raise ValueError(f"ssm_scan: x must be (BH, S, ph) and b, c one "
                         f"(BG, S, ds) shape, got {tuple(x.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    BH, S, ph = x.shape
    BG, Sb, ds = b.shape
    if min(BH, S, ph, ds) < 1 or Sb != S or BG < 1 or BH % BG:
        raise ValueError(f"ssm_scan: {BH} sequences of {S} steps cannot share "
                         f"b, c of shape {tuple(b.shape)}")
    for name, t in (("dA", dA), ("dt", dt)):
        if t.dtype != torch.float32 or tuple(t.shape) != (BH, S):
            raise ValueError(f"ssm_scan: {name} must be float32 ({BH}, {S}), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if x.dtype not in X_DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"ssm_scan: x, b, c must share float32 or bfloat16, "
                         f"got {x.dtype}, {b.dtype}, {c.dtype}")
    if chunk < 1:
        raise ValueError(f"ssm_scan: chunk must be >= 1, got {chunk}")
    return BH, S, ph, BG, ds, min(chunk, S)


def ssm_scan_plain(x, b, c, dA, dt, *, chunk: int = 128) -> torch.Tensor:
    """The kernel's chunked arithmetic in PyTorch (any chunk size)."""
    BH, S, ph, _, ds, ck = _check(x, b, c, dA, dt, chunk)
    pad = (-S) % ck
    n = (S + pad) // ck

    def chunks(t):  # (R, S[, w]) -> (BH, n, ck[, w]) float32, zero-padded
        t = t.float().repeat_interleave(BH // t.shape[0], 0)
        t = torch.nn.functional.pad(t, (0, 0, 0, pad) if t.dim() == 3 else (0, pad))
        return t.reshape(BH, n, ck, *t.shape[2:])

    xc, bc, cc, dac, dtc = (chunks(t) for t in (x, b, c, dA, dt))
    mask = torch.tril(torch.ones((ck, ck), dtype=torch.bool, device=x.device))
    h = torch.zeros((BH, ds, ph), dtype=torch.float32, device=x.device)
    ys = []
    for k in range(n):
        cum = torch.cumsum(dac[:, k], dim=-1)  # (BH, ck)
        L = torch.exp(torch.where(mask, cum[:, :, None] - cum[:, None, :], -torch.inf))
        xdt = xc[:, k] * dtc[:, k, :, None]
        bm, cm = bc[:, k], cc[:, k]
        y_intra = (cm @ bm.transpose(1, 2) * L) @ xdt
        y_state = (cm * torch.exp(cum)[:, :, None]) @ h
        total = cum[:, -1]
        decay_out = torch.exp(total[:, None] - cum)[:, :, None]
        h = torch.exp(total)[:, None, None] * h + (bm * decay_out).transpose(1, 2) @ xdt
        ys.append(y_intra + y_state)
    return torch.stack(ys, 1).reshape(BH, n * ck, ph)[:, :S].to(x.dtype)


def _pieces(t: torch.Tensor, n: int) -> list[torch.Tensor]:
    """The kernels' bf16 pieces of t, as float32 tensors: a piece is what
    is left with its low 16 bits cleared (a bf16 value, by truncation),
    and what it leaves is exact. Three pieces sum to t exactly; one is
    taken only of bf16 values."""
    rest, out = t.float(), []
    for _ in range(n):
        piece = (rest.view(torch.int32) & -65536).view(torch.float32)
        out.append(piece)
        rest = rest - piece
    return out


def _piece_product(a, b, fn) -> torch.Tensor:
    """sum of fn(a_p, b_q) over the piece pairs the kernels form (p + q <
    3), each a float32 product of bf16 values: exact products, float32
    sums."""
    return sum(fn(ap, bq) for p, ap in enumerate(a) for q, bq in enumerate(b) if p + q < 3)


def ssm_scan_pieces(x, b, c, dA, dt, *, chunk: int = 128) -> torch.Tensor:
    """The kernels' arithmetic in PyTorch, for tests: the three passes of
    ``csrc/ssm_scan.cu`` with its rescaling and bf16 pieces (:func:`_pieces`).
    x, b, c go whole when bfloat16 and as three pieces when float32; every
    float32 operand the kernels form (the rescaled B rows, (C B^T * L) *
    dt^T, h) as three. A product is the sum of the piece products with p +
    q < 3, each formed in float32 from bf16 values (exact), summed in
    float32.

    The chunk's prefix sums ``cum`` are summed in float64 and rounded to
    float32 once, as the kernels do. (a) ``s_k = (B * exp(total - cum) *
    dt)^T x``; (b) ``h_k = exp(total_k) h_{k-1} + s_k``; (c) ``y = exp(cum)
    * (C h_{k-1}) + ((C B^T * L) * dt^T) x``."""
    BH, S, ph, BG, ds, ck = _check(x, b, c, dA, dt, chunk)
    pad = (-S) % ck
    n = (S + pad) // ck
    nx = 1 if x.dtype == torch.bfloat16 else 3

    def chunks(t):  # (R, S[, w]) -> (R, n, ck[, w]), zero-padded
        t = torch.nn.functional.pad(t, (0, 0, 0, pad) if t.dim() == 3 else (0, pad))
        return t.reshape(t.shape[0], n, ck, *t.shape[2:])

    group = BH // BG
    xc, dac, dtc = chunks(x), chunks(dA), chunks(dt)
    bc = chunks(b).repeat_interleave(group, 0)
    cc = chunks(c).repeat_interleave(group, 0)
    cum = torch.cumsum(dac.double(), dim=-1).float()  # summed in float64, rounded once
    total = cum[..., -1:]
    xp, bp, cp = _pieces(xc, nx), _pieces(bc, nx), _pieces(cc, nx)
    # (a) the chunks' own states, (BH, n, ds, ph)
    u = bc.float() * (torch.exp(total - cum) * dtc)[..., None]
    s = _piece_product(_pieces(u, 3), xp, lambda u_, x_: u_.transpose(-1, -2) @ x_)
    # (b) the state entering each chunk
    h = torch.zeros((BH, ds, ph), dtype=torch.float32, device=x.device)
    h_in = []
    for k in range(n):
        h_in.append(h)
        h = torch.exp(total[:, k])[:, :, None] * h + s[:, k]
    h_in = torch.stack(h_in, 1)
    # (c) outputs
    mask = torch.tril(torch.ones((ck, ck), dtype=torch.bool, device=x.device))
    G = _piece_product(cp, bp, lambda c_, b_: c_ @ b_.transpose(-1, -2))
    L = torch.exp(torch.where(mask, cum[..., :, None] - cum[..., None, :], -torch.inf))
    m = G * L * dtc[..., None, :]
    y = torch.exp(cum)[..., None] * _piece_product(cp, _pieces(h_in, 3), torch.matmul)
    y = y + _piece_product(_pieces(m, 3), xp, torch.matmul)
    return y.reshape(BH, n * ck, ph)[:, :S].to(x.dtype)


def ssm_scan_kernel(x, b, c, dA, dt, *, chunk: int = 128) -> torch.Tensor:
    """Launch the CUDA kernels: x (BH, S, ph), b/c (BG, S, ds) of x's type
    (float32 or bfloat16), dA/dt (BH, S) float32, contiguous CUDA tensors
    on one card; ``min(chunk, S) <= 128``, ph <= 64, ds <= 128 (every such
    shape fits a block's shared memory on an H100, ds 128 at chunk 128 and
    ph 64 included). Returns y (BH, S, ph) in x's type. Allocates the
    state scratch: per chunk and sequence, round16(ph) x round16(ds)
    float32 and three times as many bf16 (163 MB for one zamba2-1.2b
    layer at B 4, S 2048). Raises if the kernels cannot be built or
    launched. Inputs that hold no data get an empty y (and the same
    scratch, so a trace's live bytes match the card's)."""
    global SSD_LAUNCHES
    BH, S, ph, BG, ds, ck = _check(x, b, c, dA, dt, chunk)
    if ck > MAX_CHUNK or ph > MAX_PH or ds > MAX_DS:
        raise ValueError(f"ssm_scan_kernel: chunk {ck}, ph {ph}, ds {ds} exceed the "
                         f"kernel's {MAX_CHUNK}, {MAX_PH}, {MAX_DS}")
    no_data = holds_no_data(x)
    dev = x.device if no_data else build.check_cuda("ssm_scan_kernel", x=x, b=b, c=c, dA=dA,
                                                     dt=dt)
    n = -(-S // ck)
    php, dsp = -(-ph // 16) * 16, -(-ds // 16) * 16
    y = torch.empty_like(x)
    # each chunk's own state (float32), exp(its decay), and the pieces of the
    # state entering each chunk (bf16), as csrc/ssm_scan.cu lays them out
    states = torch.empty((max(n - 1, 1), BH, php, dsp), dtype=torch.float32, device=dev)
    decay = torch.empty((BH, max(n - 1, 1)), dtype=torch.float32, device=dev)
    hp = torch.empty((n, BH, 3, php, dsp), dtype=torch.bfloat16, device=dev)
    if no_data:
        note_kernel("ssm_scan", (x, b, c, dA, dt, ck), y)
        return y
    built = build.load("ssm_scan.cu")
    with torch.cuda.device(dev):
        code = built.lib.ssm_scan_fwd(
            x.data_ptr(), b.data_ptr(), c.data_ptr(), dA.data_ptr(), dt.data_ptr(),
            y.data_ptr(), states.data_ptr(), decay.data_ptr(), hp.data_ptr(), BH, BG, S, ph,
            ds, ck, int(x.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(built, code, "ssm_scan")
    SSD_LAUNCHES += 1
    note_kernel("ssm_scan", (x, b, c, dA, dt, ck), y)
    return y
