"""AdamW: the reference's ``repro.optim.adamw`` in PyTorch.

Not ``torch.optim.AdamW``, which places eps, the bias corrections and
the decay differently: the reference's float32 chain, leaf by leaf,

    g      = g * min(1, clip / max(|grads|, 1e-9))       (when clipping)
    mu     = b1 mu + (1 - b1) g;   nu = b2 nu + (1 - b2) g^2
    delta  = (mu / b1c) / (sqrt(nu / b2c) + eps) + weight_decay * p
    p      = p - lr * delta

with ``b1c = 1 - b1 ** step`` and ``b2c = 1 - b2 ** step`` float32
tensors, every leaf decayed, and each result cast back to the param's and
the moments' types. Parameters, gradients and moments are keyed by
parameter name (an ``nn.Module``'s ``named_parameters()``, or a mapping);
the state is ``{"mu": {name: t}, "nu": {name: t}, "step": int32 tensor}``.
:func:`adamw_update` writes the parameters and moments IN PLACE under
``no_grad`` (the reference returns new trees): the full-width state is too
large to copy per step."""

from __future__ import annotations

from collections.abc import Callable, Mapping
from dataclasses import dataclass

import torch
from torch import nn


@dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float | None = 1.0


def named_leaves(params: nn.Module | Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters or of a mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    sums = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def adamw_init(params, moments_dtype: torch.dtype = torch.float32) -> dict:
    """Zero moments of ``moments_dtype`` on each param's device (bfloat16
    halves the state; the update still computes in float32) and step 0."""
    leaves = named_leaves(params)
    zeros = lambda: {k: torch.zeros(p.shape, dtype=moments_dtype, device=p.device)  # noqa: E731
                     for k, p in leaves.items()}
    dev = next(iter(leaves.values())).device
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: dict, params, cfg: AdamWConfig,
                 grad_norm: torch.Tensor | None = None) -> tuple[object, dict, dict]:
    """One AdamW step. Returns ``(params, state, {"grad_norm", "lr"})``:
    ``params`` and the moments updated in place, a new step counter.
    ``grad_norm`` (default: :func:`global_norm` of ``grads``) is the norm
    to clip by, for a caller whose ``grads`` are shards of the gradient."""
    leaves = named_leaves(params)
    step = state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = None
    if cfg.grad_clip_norm is not None:
        # a tensor numerator: ``number / tensor`` multiplies by a reciprocal
        clip = torch.full_like(gnorm, cfg.grad_clip_norm)
        scale = torch.clamp_max(clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = cfg.lr(step) if callable(cfg.lr) else torch.full((), cfg.lr, dtype=torch.float32,
                                                             device=gnorm.device)
    step_f = step.float()
    b1c = 1.0 - torch.pow(torch.full_like(step_f, cfg.b1), step_f)
    b2c = 1.0 - torch.pow(torch.full_like(step_f, cfg.b2), step_f)
    for name, p in leaves.items():
        # the reference's g * scale promotes a bfloat16 g to float32
        g32 = grads[name].float()
        if scale is not None:
            g32 = g32 * scale
        mu, nu = state["mu"][name], state["nu"][name]
        mu2 = cfg.b1 * mu.float() + (1 - cfg.b1) * g32
        nu2 = cfg.b2 * nu.float() + (1 - cfg.b2) * torch.square(g32)
        p32 = p.float()
        delta = (mu2 / b1c) / (torch.sqrt(nu2 / b2c) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
        mu.copy_(mu2)
        nu.copy_(nu2)
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
