"""Build and load the port's hand-written CUDA kernels."""

from __future__ import annotations

import torch


def refuse_autograd(op: str, *tensors: torch.Tensor,
                    why: str = "the reference's kernel has none either",
                    instead: str = "differentiate the plain path") -> None:
    """Raise ``RuntimeError`` when autograd would record ``op``: grad mode
    is on and a floating input requires grad. The kernels have no
    backward, as the reference's Pallas kernels have none; without this
    check their outputs would come back untracked and the gradient would
    be silently wrong. The CPU refuses too, so tests on the plain
    versions see what the card does. ``why`` and ``instead`` fill in the
    message for an op that is not a kernel."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors if t.is_floating_point()):
        raise RuntimeError(
            f"{op} has no backward ({why}): call it under torch.no_grad(), or {instead}")
