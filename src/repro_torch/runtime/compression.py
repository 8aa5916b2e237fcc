"""Gradient compression for data-parallel reduction: int8 with error
feedback, the reference's ``repro.runtime.compression`` in PyTorch.

On a multi-node fleet the data-parallel all-reduce crosses the slow
inter-node links. Int8 cuts its bytes 4x against float32 at the cost of
quantization noise; the error-feedback buffer (Seide et al. 2014;
Karimireddy et al. 2019) carries the residual into the next step, so
the noise does not bias the trajectory. Gradients and buffers are keyed
by parameter name, as the optimizer's state is."""

from __future__ import annotations

from collections.abc import Mapping

import torch

from repro_torch.core.quantization import true_divide
from repro_torch.optim.adamw import named_leaves


def init_error_feedback(params) -> dict[str, torch.Tensor]:
    """Float32 zeros shaped as each parameter, on its device."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named_leaves(params).items()}


def compress_decompress(g: torch.Tensor, err: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 round trip with error feedback: ``(the
    decompressed gradient in g's type, the new float32 residual)``. The
    scale is ``amax / 127`` divided exactly (1 for an all-zero tensor);
    values round half to even and clip to [-127, 127]."""
    g32 = g.float() + err
    amax = torch.max(torch.abs(g32))
    scale = torch.where(amax > 0, true_divide(amax, 127.0), 1.0)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq.to(g.dtype), g32 - deq


def compress_grads(grads: Mapping[str, torch.Tensor], err_state: Mapping[str, torch.Tensor]
                   ) -> tuple[dict, dict]:
    """:func:`compress_decompress` leaf by leaf: what would cross the wire
    is each leaf's int8 values and one float32 scale."""
    out = {k: compress_decompress(g, err_state[k]) for k, g in grads.items()}
    return {k: o[0] for k, o in out.items()}, {k: o[1] for k, o in out.items()}


def wire_bytes(grads: Mapping[str, torch.Tensor]) -> tuple[int, int]:
    """(compressed, uncompressed float32) bytes a data-parallel all-reduce
    would move: one byte per value plus a 4-byte scale per leaf, against
    four bytes per value."""
    comp = sum(x.numel() + 4 for x in grads.values())
    raw = sum(x.numel() * 4 for x in grads.values())
    return comp, raw
