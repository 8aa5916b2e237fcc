"""The chunked SSD scan kernel (``csrc/ssm_scan.cu``): its wrapper, launch
count and chunked plain PyTorch version.

:func:`ssm_scan_kernel` replaces the reference's ``_ssd_kernel``
(``kernels/ssm_scan/kernel.py``) and launches the CUDA kernel on CUDA
tensors, raising on anything else. :func:`ssm_scan_plain` computes the
same function with PyTorch on any device, chunk by chunk with the TPU
kernel's arithmetic: float32, ``-inf`` above the diagonal before ``exp``,
a zero state at the first chunk and a ragged tail zero-padded. B and C
may be shared by groups of heads: ``b``/``c`` of (BG, S, ds) serve
sequence ``bh`` from row ``bh // (BH // BG)``, as the flash kernel maps
kv heads; BG = BH is the reference's layout.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["MAX_CHUNK", "MAX_DS", "MAX_PH", "SSD_LAUNCHES", "X_DTYPES",
           "reset_launch_count", "ssm_scan_kernel", "ssm_scan_plain"]

# Kernel launches since the last reset_launch_count(); bumped only where
# the kernel is launched, never by the plain version.
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


def ssm_scan_kernel(x, b, c, dA, dt, *, chunk: int = 128) -> torch.Tensor:
    """Launch the CUDA kernel: x (BH, S, ph), b/c (BG, S, ds) of x's type
    (float32 or bfloat16), dA/dt (BH, S) float32, contiguous CUDA tensors
    on one card; ``min(chunk, S) <= 128``, ph <= 64, ds <= 128. Returns y
    (BH, S, ph) in x's type. Raises if the kernel cannot be built or
    launched, as when the shapes need more shared memory than a block of
    the card has (on an H100, ds above 102 at chunk 128 and ph 64)."""
    global SSD_LAUNCHES
    BH, S, ph, BG, ds, ck = _check(x, b, c, dA, dt, chunk)
    if ck > MAX_CHUNK or ph > MAX_PH or ds > MAX_DS:
        raise ValueError(f"ssm_scan_kernel: chunk {ck}, ph {ph}, ds {ds} exceed the "
                         f"kernel's {MAX_CHUNK}, {MAX_PH}, {MAX_DS}")
    dev = build.check_cuda("ssm_scan_kernel", x=x, b=b, c=c, dA=dA, dt=dt)
    built = build.load("ssm_scan.cu")
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        code = built.lib.ssm_scan_fwd(
            x.data_ptr(), b.data_ptr(), c.data_ptr(), dA.data_ptr(), dt.data_ptr(),
            y.data_ptr(), BH, BG, S, ph, ds, ck, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(built, code, "ssm_scan")
    SSD_LAUNCHES += 1
    return y
