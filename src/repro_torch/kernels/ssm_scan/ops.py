"""Public op: chunked SSD scan in model layout.

The port of the reference's ``kernels/ssm_scan/ops.py``. Its
``interpret`` switch gives way to the tensors' device: CPU tensors run
the kernel's chunked plain version, CUDA tensors launch the kernel
(``csrc/ssm_scan.cu``) or raise; tensors that hold no data (``meta``,
``FakeTensorMode``) get the kernel's empty output. The reference broadcasts b and c over
the heads; here the kernel reads them through a head-group index (all H
heads of a batch row share one row of b and c), the same function
without the copies."""

from __future__ import annotations

import torch

from repro_torch.kernels import holds_no_data, refuse_autograd
from repro_torch.kernels.ssm_scan.kernel import X_DTYPES, ssm_scan_kernel, ssm_scan_plain

__all__ = ["ssm_scan"]


def ssm_scan(x, b, c, dA, dt, *, chunk: int = 128) -> torch.Tensor:
    """x: (B, S, H, ph); b/c: (B, S, ds) shared across heads; dA/dt: (B, S, H).

    Returns y: (B, S, H, ph) in x's type. The scan computes in float32,
    as the reference kernel does after casting its inputs: x, b and c
    of one type, float32 or bfloat16, go to the kernel as they are; any
    other mix (bfloat16 x with float32 b, c, say) goes as float32, which
    holds every such value exactly. Raises ``RuntimeError`` where autograd
    would record it, on either device: it has no backward."""
    refuse_autograd("ssm_scan", x, b, c, dA, dt)
    B, S, H, ph = x.shape
    same = b.dtype == c.dtype == x.dtype and x.dtype in X_DTYPES
    kind = x.dtype if same else torch.float32
    xf = x.transpose(1, 2).reshape(B * H, S, ph).to(kind).contiguous()
    dAf = dA.transpose(1, 2).reshape(B * H, S).to(torch.float32).contiguous()
    dtf = dt.transpose(1, 2).reshape(B * H, S).to(torch.float32).contiguous()
    scan = ssm_scan_plain if x.device.type == "cpu" and not holds_no_data(x) else ssm_scan_kernel
    y = scan(xf, b.to(kind).contiguous(), c.to(kind).contiguous(), dAf, dtf, chunk=chunk)
    return y.reshape(B, H, S, ph).transpose(1, 2).to(x.dtype)
