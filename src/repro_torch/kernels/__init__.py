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


def holds_no_data(t: torch.Tensor) -> bool:
    """True for a tensor with shapes and types but no values: a ``meta``
    tensor, or a ``FakeTensorMode`` tensor (which reports its stand-in
    device). The kernel ops hand such a tensor to neither a kernel nor a
    plain version: they return an empty output of the right shape and
    type and tell the op counters (:func:`note_kernel`)."""
    from torch._subclasses.fake_tensor import is_fake

    return t.device.type == "meta" or is_fake(t)


def note_kernel(op: str, inputs: tuple, out: torch.Tensor) -> None:
    """Tell every op counter on the dispatch mode stack
    (``parallel.op_analysis.OpCounter``) that kernel op ``op`` ran on
    ``inputs`` (the kernel's own arguments) into ``out``. A kernel launch
    goes through ctypes, past the dispatcher that the counters watch, so
    each kernel function calls this where it launches, and on tensors
    that hold no data where it would have."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        if hasattr(mode, "note_kernel"):
            mode.note_kernel(op, inputs, out)
