"""Pipeline-parallel execution of planner-chosen splits.

The port's counterpart of ``repro.parallel.pipeline``, the runtime of
:func:`repro_torch.core.planner.plan_pipeline`: a split plan assigns
contiguous layer ranges to pipeline stages, and this module runs them as
a GPipe-style microbatch pipeline, rotating the microbatch activations
from stage ``s`` to ``s + 1`` each tick: the hop whose cost the paper's
Eq. 7 models.

Execution model (the reference's, tick for tick):
  * stage ``s`` holds the stacked parameters of its layer range; uneven
    plans are padded with zero layers behind a mask to the deepest
    stage (:func:`pad_stage_params`);
  * ``M`` microbatches stream through ``S`` stages over ``M + S - 1``
    ticks;
  * each tick, every stage applies all of its ``max_depth`` layers to
    its resident activation (bubble ticks included, as the reference
    computes them), then the ring rotates, stage 0 injects the next
    microbatch and stage ``S - 1`` emits a finished one.

Stacked parameters are a ``dict[str, Tensor]`` with a leading layer axis
(the reference's pytree). :func:`pipelined_forward` runs in two forms
over one tick loop:

* in one process over ``devices`` (one per stage; ``None`` is the card
  for every stage): the rotation is ``.to(devices[(s + 1) % S])``;
* over a ``torch.distributed`` process group, where rank ``s`` is stage
  ``s``: one ``batch_isend_irecv`` pair per tick rotates the ring, and
  the last stage's outputs reach every rank through a masked
  ``all_reduce(SUM)`` (``x + 0`` is exact), the reference's masked
  ``psum``. With ``gloo`` the tensors live on the CPU.

The one-process form is differentiable, as the reference's (a plain JAX
function that ``jax.grad`` goes through): the ``.to`` ring, the masked
``torch.where`` and the indexed writes into the outputs all record, so
a loss on the outputs reaches the stage parameters and the microbatches.
The bubble ticks' results never reach the outputs, so the backward never
visits them, and they are freed when the call returns. The group form
raises ``RuntimeError`` where autograd would record: ``batch_isend_irecv``
and ``all_reduce`` have no backward.

:func:`stack_blocks` and :func:`transformer_block_apply` run a
homogeneous :class:`~repro_torch.models.transformer.Transformer`'s
blocks through the pipeline at any width: one block applied to
``(mb, S, d)`` with ``torch.func.functional_call`` under the model's
float32 scope, so in bf16 with ``use_flash_kernel`` each block launches
the flash kernel, as the model's prefill does.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.func import functional_call

from repro_torch.device import resolve_device
from repro_torch.kernels import refuse_autograd

__all__ = [
    "pad_stage_params",
    "pipelined_forward",
    "run_pipeline",
    "stack_blocks",
    "stage_assignment",
    "transformer_block_apply",
]


def stage_assignment(plan, n_layers: int) -> list[tuple[int, int]]:
    """[(first, last)] 0-indexed inclusive layer ranges per stage of a
    plan with ``splits`` (1-indexed layer boundaries)."""
    bounds = [0, *plan.splits, n_layers]
    return [(bounds[i], bounds[i + 1] - 1) for i in range(len(bounds) - 1)]


def pad_stage_params(stacked_params: dict[str, torch.Tensor], ranges,
                     max_depth: int) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Slice the (L, ...) stacked block parameters into (S, max_depth, ...)
    per-stage stacks, padding short stages with zero layers, and the
    (S, max_depth) bool mask that is False on the padding."""
    out = {}
    for name, t in stacked_params.items():
        stages = []
        for a, b in ranges:
            sl = t[a:b + 1]
            if b - a + 1 < max_depth:
                sl = torch.cat([sl, sl.new_zeros((max_depth - (b - a + 1), *t.shape[1:]))])
            stages.append(sl)
        out[name] = torch.stack(stages)
    depth = torch.tensor([b - a + 1 for a, b in ranges])
    mask = torch.arange(max_depth)[None, :] < depth[:, None]
    return out, mask


def _stage_slice(stage_params: dict[str, torch.Tensor], s: int, device) -> list[dict]:
    """Stage ``s``'s layers on ``device``, one parameter dict per layer."""
    local = {k: v[s].to(device) for k, v in stage_params.items()}
    depth = next(iter(local.values())).shape[0]
    return [{k: v[j] for k, v in local.items()} for j in range(depth)]


def _apply_stage(block_apply: Callable, layers: list[dict], mask: torch.Tensor, x):
    for lp, m in zip(layers, mask):
        x = torch.where(m, block_apply(lp, x), x)
    return x


def pipelined_forward(
    block_apply: Callable,  # (layer_params, x) -> x
    stage_params: dict[str, torch.Tensor],  # (S, depth, ...) per stage
    layer_mask: torch.Tensor,  # (S, depth) bool: False for padded layers
    microbatches: torch.Tensor,  # (M, mb, ...) activations entering stage 0
    *,
    devices: Sequence | None = None,
    group=None,
) -> torch.Tensor:
    """Run the microbatch pipeline; returns the (M, mb, ...) outputs of
    the last stage on the microbatches' device.

    Without ``group``: every stage in this process, stage ``s`` on
    ``devices[s]`` (``None``: the card for each; ``RuntimeError`` without
    one). With ``group``: this process is stage ``group.rank()`` of
    ``group.size()`` stages; every rank passes the same ``stage_params``,
    ``layer_mask`` and ``microbatches`` and gets the whole output back.
    Differentiable without ``group``; with one, ``RuntimeError`` where
    autograd would record."""
    if group is not None:
        return _forward_group(block_apply, stage_params, layer_mask,
                              microbatches, group)
    S = layer_mask.shape[0]
    devices = [resolve_device(None)] * S if devices is None \
        else [resolve_device(d) for d in devices]
    if len(devices) != S:
        raise ValueError(f"{len(devices)} devices for {S} stages")
    M = microbatches.shape[0]
    stages = [_stage_slice(stage_params, s, devices[s]) for s in range(S)]
    masks = [layer_mask[s].to(devices[s]) for s in range(S)]
    bufs = [torch.zeros_like(microbatches[0], device=d) for d in devices]
    outputs = torch.zeros_like(microbatches, device=devices[-1])
    for t in range(M + S - 1):
        bufs[0] = microbatches[min(t, M - 1)].to(devices[0])
        bufs = [_apply_stage(block_apply, stages[s], masks[s], bufs[s])
                for s in range(S)]
        if t >= S - 1:
            outputs[t - (S - 1)] = bufs[-1]
        # rotate the ring: s -> s + 1 (the Eq. 7-priced activation hop)
        bufs = [bufs[s - 1].to(devices[s]) for s in range(S)]
    return outputs.to(microbatches.device)


def _forward_group(block_apply, stage_params, layer_mask, microbatches, group):
    import torch.distributed as dist

    refuse_autograd("pipelined_forward over a process group", *stage_params.values(),
                    microbatches, why="batch_isend_irecv and all_reduce record none",
                    instead="differentiate the one-process form (devices=...)")
    S, s = group.size(), group.rank()
    if layer_mask.shape[0] != S:
        raise ValueError(f"{layer_mask.shape[0]} stages on a group of {S} ranks")
    M = microbatches.shape[0]
    layers = _stage_slice(stage_params, s, microbatches.device)
    mask = layer_mask[s].to(microbatches.device)
    to_next = dist.get_global_rank(group, (s + 1) % S)
    from_prev = dist.get_global_rank(group, (s - 1) % S)
    buf = torch.zeros_like(microbatches[0])
    outputs = torch.zeros_like(microbatches)
    for t in range(M + S - 1):
        if s == 0:
            buf = microbatches[min(t, M - 1)]
        buf = _apply_stage(block_apply, layers, mask, buf).contiguous()
        if s == S - 1 and t >= S - 1:
            outputs[t - (S - 1)] = buf
        if S > 1:  # rotate the ring: s -> s + 1
            recv = torch.empty_like(buf)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, buf, to_next, group),
                    dist.P2POp(dist.irecv, recv, from_prev, group)]):
                req.wait()
            buf = recv
    # only the last stage wrote its outputs, the others hold zeros: the sum
    # broadcasts them (the reference's masked psum; x + 0 is exact)
    dist.all_reduce(outputs, op=dist.ReduceOp.SUM, group=group)
    return outputs


def run_pipeline(plan, block_apply: Callable, stacked_params: dict[str, torch.Tensor],
                 n_layers: int, microbatches: torch.Tensor, *, devices=None,
                 group=None) -> torch.Tensor:
    """Plan -> padded stage stacks -> pipelined run (see
    :func:`pipelined_forward` for ``devices`` and ``group``)."""
    ranges = stage_assignment(plan, n_layers)
    max_depth = max(b - a + 1 for a, b in ranges)
    stage_stack, mask = pad_stage_params(stacked_params, ranges, max_depth)
    return pipelined_forward(block_apply, stage_stack, mask, microbatches,
                             devices=devices, group=group)


def stack_blocks(model) -> dict[str, torch.Tensor]:
    """A homogeneous ``Transformer``'s blocks as ``{name: (L, ...)}``
    stacked parameters (a copy, on the model's device). The stack records
    autograd where the parameters require grad, so a loss on the
    pipeline's outputs reaches them; ``torch.stack`` saves nothing for its
    backward."""
    from repro_torch.models.transformer import Block

    blocks = list(model.blocks)
    if not blocks or not all(isinstance(b, Block) for b in blocks):
        raise ValueError("stack_blocks takes a homogeneous attention stack")
    names = [n for n, _ in blocks[0].named_parameters()]
    per = [dict(b.named_parameters()) for b in blocks]
    return {n: torch.stack([p[n] for p in per]) for n in names}


def transformer_block_apply(model, cfg, positions: torch.Tensor) -> Callable:
    """``block_apply(layer_params, x)`` for ``model``'s blocks: one
    ``Block`` on ``x`` (mb, S, d) at ``positions`` (mb, S), uncached, under
    the model's float32 scope, as ``Transformer.forward`` runs it."""
    template = model.blocks[0]

    def block_apply(layer_params: dict, x: torch.Tensor) -> torch.Tensor:
        with model.float32_scope():
            return functional_call(template, layer_params,
                                   (cfg, x, positions, None, 0, False))

    return block_apply
