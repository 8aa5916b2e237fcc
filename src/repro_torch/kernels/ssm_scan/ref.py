"""Sequential oracle for the SSD scan kernel, the port's copy of the
reference's ``kernels/ssm_scan/ref.py``: the exact recurrence

    h_t = exp(dA_t) h_{t-1} + dt_t * B_t x_t^T      (outer product, ds x ph)
    y_t = C_t . h_t

one step at a time in float32, all sequences at once."""

from __future__ import annotations

import torch

__all__ = ["ssm_scan_ref"]


def ssm_scan_ref(x, b, c, dA, dt):
    """x: (BH, S, ph); b/c: (BG, S, ds) with BG dividing BH (sequence
    ``bh`` reads row ``bh // (BH // BG)``; BG = BH is the reference's
    layout); dA/dt: (BH, S). Returns (BH, S, ph) in x's type."""
    BH, S, ph = x.shape
    group = BH // b.shape[0]
    xf, dAf, dtf = x.float(), dA.float(), dt.float()
    bf = b.float().repeat_interleave(group, 0)
    cf = c.float().repeat_interleave(group, 0)
    h = torch.zeros((BH, b.shape[2], ph), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        outer = bf[:, t, :, None] * xf[:, t, None, :]
        h = torch.exp(dAf[:, t])[:, None, None] * h + dtf[:, t][:, None, None] * outer
        ys.append(torch.einsum("bd,bdp->bp", cf[:, t], h))
    return torch.stack(ys, 1).to(x.dtype)
