"""Step functions: the train step, prefill and decode.

The counterparts of ``make_train_step``, ``make_prefill_step`` and
``make_decode_step`` in the reference's ``repro.launch.steps``. PyTorch
runs eagerly, so a step is a plain closure. The reference's mesh and
sharding constructors (``build_cell``, ``abstract_state``) are not ported:
the port runs on one card."""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch
from torch import nn

from repro_torch.core.quantization import true_divide
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.optim import AdamWConfig, adamw_update


@contextmanager
def _trainable(params: nn.Module):
    """Every parameter of ``params`` requires grad for the block; each
    flag is restored on exit (the port's models hold frozen parameters)."""
    flags = [(p, p.requires_grad) for p in params.parameters()]
    try:
        for p, _ in flags:
            p.requires_grad_(True)
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def loss_and_grads(cfg: ModelConfig, params: nn.Module, batch: dict
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``(loss, {name: gradient})`` of :func:`~repro_torch.models.transformer.loss_fn`,
    each gradient in its parameter's type (zeros for a parameter the loss
    does not reach, as ``jax.grad`` gives). The forward and the backward,
    with any recompute of checkpointed blocks, run in one IEEE float32
    scope on the card. The gradients come from ``torch.autograd.grad``:
    nothing accumulates into ``.grad``."""
    names, leaves = zip(*params.named_parameters())
    with _trainable(params), torch.enable_grad(), params.float32_scope():
        loss = T.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {name: torch.zeros_like(p) if g is None else g
                           for name, p, g in zip(names, leaves, grads)}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    n_microbatches: int | None = None, accum_shardings=None):
    """``train_step(params, opt_state, batch)`` -> ``(params, opt_state,
    {"loss", "grad_norm", "lr"})``: one AdamW step (``optim.adamw_update``)
    that updates ``params`` (a ``Transformer``) and the moments IN PLACE
    and returns them.

    With N = ``n_microbatches`` (default ``cfg.train_microbatches``) > 1
    the batch arrives split as (N, B/N, ...) (vision positions (N, 3, B/N,
    S)): each microbatch's gradient is cast to ``cfg.grad_accum_dtype``,
    added to an accumulator in microbatch order, and the sum divided by
    N; the loss is the microbatches' mean. Letting autograd accumulate
    ``.grad`` over N backward passes would sum in the parameters' type
    (bfloat16), a different result. ``accum_shardings`` (the reference's
    ZeRO layout for the accumulator) is not ported: a value other than
    ``None`` raises ``NotImplementedError``."""
    if accum_shardings is not None:
        raise NotImplementedError("accum_shardings: sharded gradient accumulation is not "
                                  "ported (ROADMAP item 16, parallel/sharding.py)")
    opt_cfg = opt_cfg or AdamWConfig()
    N = cfg.train_microbatches if n_microbatches is None else n_microbatches

    def train_step(params, opt_state, batch):
        if N <= 1:
            loss, grads = loss_and_grads(cfg, params, batch)
        else:
            grads, loss = accumulated_grads(cfg, params, batch, N)
        params, opt_state, metrics = adamw_update(grads, opt_state, params, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def accumulated_grads(cfg: ModelConfig, params: nn.Module, batch: dict, n: int,
                      dtype: torch.dtype | None = None
                      ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """The mean gradient and loss over the ``n`` microbatches of ``batch``
    (leading axis): each gradient cast to ``dtype`` (default
    ``cfg.grad_accum_dtype``) and added in microbatch order, the sum
    divided by ``n``."""
    dt = dtype or torch_dtype(cfg.grad_accum_dtype)
    accum = {k: torch.zeros(p.shape, dtype=dt, device=p.device)
             for k, p in params.named_parameters()}
    losses = []
    for i in range(n):
        loss, grads = loss_and_grads(cfg, params, {k: v[i] for k, v in batch.items()})
        for k, g in grads.items():
            accum[k] += g.to(dt)
        losses.append(loss)
        del grads
    return ({k: true_divide(a, float(n)) for k, a in accum.items()},
            torch.mean(torch.stack(losses)))


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch)`` -> the last position's logits (B, V),
    or (B, n_codebooks, V) for audio codes. ``batch`` holds ``tokens``,
    ``codes`` or ``embeds`` as the config's frontend takes, and optional
    ``positions`` ((3, B, S) for M-RoPE).

    It runs the uncached forward, so a block pattern's Mamba2 and mLSTM
    blocks take their chunked forms (the SSD kernel on the card).
    Serving prefill has no backward pass, so causal block skipping is on
    (``causal_skip=True``), as in the reference."""
    cfg = dataclasses.replace(cfg, causal_skip=True)

    def prefill_step(params, batch):
        logits, _ = T.forward(cfg, params, batch)
        return logits[:, -1]

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, inputs, cache)`` -> ``(logits, cache)``."""

    def decode_step(params, inputs, cache):
        return T.serve_step(cfg, params, inputs, cache)

    return decode_step
