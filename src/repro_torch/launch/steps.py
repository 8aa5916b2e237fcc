"""Step functions: the train step, prefill and decode, and the cells that
lay them out on a mesh.

The counterparts of ``make_train_step``, ``make_prefill_step``,
``make_decode_step``, ``abstract_state`` and ``build_cell`` in the
reference's ``repro.launch.steps``. PyTorch runs eagerly, so a step is a
plain closure.

A cell (:func:`build_cell`) is one (arch x shape) step on a
``DeviceMesh``: the step, its example arguments (``meta`` tensors: the
dry run's stand-ins) and the
:class:`~repro_torch.parallel.sharding.NamedSharding` of every argument,
by the reference's rules. Its caller lays real tensors out with
:func:`~repro_torch.parallel.sharding.distribute`, and the step takes
those DTensors:

* the weights are stored by their specs; the step gathers them all
  whole at once (``full_tensor()``) and runs the unsharded code on the
  rank's share of the batch (its DP shard; the ranks of a model group
  compute the same). Every rank so holds the whole model while a step
  runs (:func:`gathered_bytes` counts it for the dry run). XLA partitions
  the reference's compute itself from the same specs; a tensor-parallel
  compute plan is not ported;
* the training cell's gradient accumulator is kept DP-sharded (ZeRO,
  :func:`zero_accumulated_grads`): each microbatch's gradient is cast to
  ``grad_accum_dtype``, summed over the DP ranks with ``all_reduce`` (one
  code path for NCCL and gloo, whose CPU form lacks reduce-scatter: the
  same sum as a reduce-scatter, at twice its wire bytes) and the rank's
  slice added to its shard, in microbatch order. AdamW then updates each
  moment shard and the matching slice of the weight, and the new weight
  is gathered back to its own layout;
* decode gathers each cache entry but for its DP batch shard, runs the
  step and writes the rank's shard back.

On one rank every gather, reduction and slice is an identity in value,
and a cell is bit-equal to the step without a mesh. The same collectives
run there as on a larger mesh, but for one: a one-rank mesh takes the
local tensor in place of ``redistribute`` in :func:`_relayout`, since the
decode cache it relays out may fill half the card."""

from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager

import torch
from torch import nn

from repro_torch.configs import (ShapeSpec, cache_specs, effective_microbatches, input_specs,
                                 to_meta)
from repro_torch.core.quantization import true_divide
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel import sharding as SH


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
    (bfloat16), a different result.

    ``accum_shardings`` (``{name: NamedSharding}`` on a ``DeviceMesh``,
    ``build_cell``'s moment layout) pins the accumulator to the ZeRO
    layout: the step then takes a cell's DTensors (``params`` ``{name:
    DTensor}``, the moments as ``adamw_init``'s tree of DTensors, the batch
    by ``input_sharding``), accumulates with :func:`zero_accumulated_grads`
    and updates every shard in place (the module docstring says how)."""
    opt_cfg = opt_cfg or AdamWConfig()
    N = cfg.train_microbatches if n_microbatches is None else n_microbatches
    if accum_shardings is not None:
        if not isinstance(accum_shardings, dict) or not all(
                isinstance(s, SH.NamedSharding) for s in accum_shardings.values()):
            raise TypeError("accum_shardings: a {name: NamedSharding} mapping (build_cell's "
                            f"moment layout), got {type(accum_shardings).__name__}")
        return _zero_train_step(cfg, opt_cfg, N, accum_shardings)

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


# --------------------------------------------------------------------------
# cells: the steps on a mesh
# --------------------------------------------------------------------------


def abstract_state(cfg: ModelConfig, with_opt: bool = True):
    """``meta`` stand-ins for the parameters (``{name: tensor}``, the
    ``Transformer``'s names) and, with ``with_opt``, the AdamW state
    (``{"mu", "nu", "step"}``, moments in ``cfg.opt_moments_dtype``): the
    model is built under ``FakeTensorMode``, so nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        model = T.Transformer(cfg, device="cpu")
        params = dict(model.named_parameters())
        opt = adamw_init(params, moments_dtype=torch_dtype(cfg.opt_moments_dtype)) \
            if with_opt else None
    params = to_meta(params)
    return (params, to_meta(opt)) if with_opt else params


def _dp_size(mesh) -> int:
    shape = SH.mesh_shape(mesh)
    return math.prod(shape[a] for a in SH.dp_axes(mesh))


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, opt_cfg: AdamWConfig | None = None):
    """``(step, example_args, shardings)`` for one (arch x shape) cell on
    ``mesh`` (a ``DeviceMesh``; a ``{axis: size}`` mapping gives the
    shardings without a process group, but the step needs the mesh).
    ``example_args`` are ``meta`` tensors and ``shardings`` has their
    structure, a ``NamedSharding`` per tensor:

    * train: ``(params, opt_state, batch)``; parameters by
      ``params_sharding(fsdp=cfg.fsdp)``, the moments always
      ``fsdp=True`` (ZeRO-1), and the step's ``accum_shardings`` the
      moments' layout; ``effective_microbatches(cfg, shape, dp)``
      microbatches;
    * prefill: ``(params, batch)``, parameters by ``cfg.fsdp_inference``;
      the step returns the last position's logits, gathered whole;
    * decode: ``(params, inputs, cache)``, the cache by
      ``cache_sharding``; the step returns ``(logits, cache)``, the cache
      updated in place.

    The inputs are laid out by ``input_sharding``."""
    dp = _dp_size(mesh)
    batch = input_specs(cfg, shape, dp_size=dp)
    b_shard = SH.input_sharding(cfg, mesh, batch)

    if shape.kind == "train":
        params, opt = abstract_state(cfg, with_opt=True)
        p_shard = SH.params_sharding(params, mesh, fsdp=cfg.fsdp)
        # optimizer moments always DP-sharded (ZeRO-1), the accumulator too
        o_shard = SH.params_sharding(opt, mesh, fsdp=True)
        step = make_train_step(cfg, opt_cfg, n_microbatches=effective_microbatches(cfg, shape, dp),
                               accum_shardings=o_shard["mu"])
        return step, (params, opt, batch), (p_shard, o_shard, b_shard)

    params = abstract_state(cfg, with_opt=False)
    p_shard = SH.params_sharding(params, mesh, fsdp=cfg.fsdp_inference)
    if shape.kind == "prefill":
        return _sharded_prefill_step(cfg), (params, batch), (p_shard, b_shard)

    cache = cache_specs(cfg, shape)
    c_shard = SH.cache_sharding(cfg, cache, mesh, shape.global_batch)
    return _sharded_decode_step(cfg), (params, batch, cache), (p_shard, b_shard, c_shard)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _dp_placements(placements, mesh) -> tuple:
    """``placements`` on ``mesh`` with every mesh dim but the DP axes
    replicated."""
    from torch.distributed.tensor import Replicate

    dp = SH.dp_axes(mesh)
    return tuple(p if name in dp else Replicate()
                 for name, p in zip(mesh.mesh_dim_names, placements))


def _relayout(t, placements) -> torch.Tensor:
    """The local tensor of DTensor ``t`` laid out as ``placements``. On a
    mesh of one rank the local tensor is the whole value in any layout;
    it is taken as it is there, so that a cache that fills half the card
    is not copied."""
    if t.device_mesh.size() == 1 or tuple(t.placements) == tuple(placements):
        return t.to_local()
    return t.redistribute(t.device_mesh, placements).to_local()


def _cache_keep(main_placements, placements, mesh) -> tuple:
    """The layout decode runs a cache entry in: its DP batch shard kept and
    every other mesh dim gathered. The batch dim is DP-sharded in the
    inputs (``main_placements``) and the cache alike, or in neither; then
    a long-context cache's sequence shards are gathered too."""
    from torch.distributed.tensor import Replicate, Shard

    if any(isinstance(p, Shard) for p in _dp_placements(main_placements, mesh)):
        return _dp_placements(placements, mesh)
    return (Replicate(),) * mesh.ndim


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_bytes(t: torch.Tensor, mesh, placements) -> int:
    """Bytes of this rank's shard of ``t`` laid out as ``placements``."""
    from torch.distributed.tensor import distribute_tensor

    return _bytes(distribute_tensor(t, mesh, placements, src_data_rank=None).to_local())


def gathered_bytes(cfg: ModelConfig, kind: str, args, shardings) -> dict[str, int]:
    """Bytes per device that a cell's step (``build_cell``'s ``args`` and
    ``shardings``, ``kind`` its shape's) holds beyond its arguments, by
    the rules its code follows:

    * ``params``: every parameter that its layout shards, gathered whole
      (:class:`_Gathered` gathers them all at once);
    * train, ``grads``: the backward gives every gradient whole, in its
      parameter's type; ``accum``: the ZeRO accumulator, a shard of each
      by the moments' layout in ``grad_accum_dtype``;
    * decode, ``cache``: each cache entry relaid out to its DP shard
      (:func:`_cache_keep`), where that is a new tensor.

    Activations and other temporaries are not counted: with the arguments
    this is a lower bound of the step's peak."""
    from torch.distributed.tensor import Shard

    params, p_shard = args[0], shardings[0]
    out = {"params": sum(_bytes(t) for k, t in params.items()
                         if any(isinstance(p, Shard) for p in p_shard[k].placements))}
    if kind == "train":
        mu, mu_shard = args[1]["mu"], shardings[1]["mu"]
        item = torch_dtype(cfg.grad_accum_dtype).itemsize
        out["grads"] = sum(_bytes(t) for t in params.values())
        out["accum"] = sum(_local_bytes(t, mu_shard[k].mesh, mu_shard[k].placements)
                           // t.element_size() * item for k, t in mu.items())
    elif kind == "decode":
        inputs, b_shard, cache, c_shard = args[1], shardings[1], args[2], shardings[2]
        main = next(b_shard[k] for k in inputs if k in ("tokens", "codes", "embeds"))
        sizes = []

        def relaid(t, s):
            keep = _cache_keep(main.placements, s.placements, s.mesh)
            if s.mesh.size() > 1 and tuple(keep) != tuple(s.placements):
                sizes.append(_local_bytes(t, s.mesh, keep))

        SH.tree_map(relaid, cache, c_shard)
        out["cache"] = sum(sizes)
    return out


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` are the same elements of one storage (also for
    ``meta`` tensors, whose data pointers are all 0)."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset() and a.shape == b.shape
            and a.stride() == b.stride())


def _store(t, local: torch.Tensor, placements) -> None:
    """Write ``local`` (laid out as ``placements``) into DTensor ``t``."""
    from torch.distributed.tensor import DTensor

    mine = t.to_local()
    if _same_memory(local, mine):
        return  # the step wrote the shard in place
    if tuple(t.placements) != tuple(placements):
        local = DTensor.from_local(local, t.device_mesh, placements, run_check=False
                                   ).redistribute(t.device_mesh, t.placements).to_local()
    mine.copy_(local)


def _gather_rows(x: torch.Tensor, like) -> torch.Tensor:
    """Rows of ``x`` (dim 0) computed on the DP batch shard of the input
    DTensor ``like``, gathered whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = tuple(Shard(0) if isinstance(p, Shard) else Replicate()
                       for p in _dp_placements(like.placements, like.device_mesh))
    if all(isinstance(p, Replicate) for p in placements):
        return x
    return DTensor.from_local(x, like.device_mesh, placements, run_check=False).full_tensor()


class _Gathered:
    """A ``Transformer`` whose parameters are a cell's gathered weights for
    the duration of a ``with`` block: built once (under ``FakeTensorMode``,
    nothing allocated), given the whole tensors on entry and let go of
    them on exit, so the unsharded code runs unchanged. For ``meta``
    weights (the dry run's trace) the template is built on the CPU: a
    model's device is its weights', and every weight is replaced."""

    def __init__(self, cfg: ModelConfig):
        self.cfg, self.model = cfg, None

    @contextmanager
    def __call__(self, params: dict):
        from torch._subclasses.fake_tensor import FakeTensorMode

        whole = {k: _whole(v) for k, v in params.items()}
        if self.model is None:
            dev = next(iter(whole.values())).device
            dev = "cpu" if dev.type == "meta" else dev
            with FakeTensorMode():
                self.model = T.Transformer(self.cfg, device=dev)
        slots = [(self.model.get_submodule(owner)._parameters, leaf, whole[name])
                 for name in whole for owner, _, leaf in [name.rpartition(".")]]
        try:
            for slots_of, leaf, t in slots:
                slots_of[leaf] = nn.Parameter(t, requires_grad=False)
            yield self.model
        finally:
            for slots_of, leaf, _ in slots:
                slots_of[leaf] = None


def _sharded_prefill_step(cfg: ModelConfig):
    step, gathered = make_prefill_step(cfg), _Gathered(cfg)

    def prefill_step(params, batch):
        with gathered(params) as model:
            logits = step(model, {k: _local(v) for k, v in batch.items()})
        main = next(v for k, v in batch.items() if k in ("tokens", "codes", "embeds"))
        return _gather_rows(logits, main)

    return prefill_step


def _sharded_decode_step(cfg: ModelConfig):
    step, gathered = make_decode_step(cfg), _Gathered(cfg)

    def decode_step(params, inputs, cache):
        main = next(v for k, v in inputs.items() if k in ("tokens", "codes", "embeds"))
        keep = SH.tree_map(lambda t: _cache_keep(main.placements, t.placements, t.device_mesh),
                           cache)
        local = SH.tree_map(_relayout, cache, keep)
        with gathered(params) as model:
            logits, new = step(model, {k: _local(v) for k, v in inputs.items()}, local)
        SH.tree_map(_store, cache, new, keep)
        return _gather_rows(logits, main), cache

    return decode_step


def _dp_sum_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the DP ranks of ``mesh`` in place (one ``all_reduce``
    per DP mesh dim)."""
    import torch.distributed as dist

    for axis in SH.dp_axes(mesh):
        dist.all_reduce(t, group=mesh.get_group(axis))
    return t


def _slice(full: torch.Tensor, sharding: SH.NamedSharding) -> torch.Tensor:
    """This rank's shard of ``full`` (identical on every rank) by ``sharding``."""
    return SH.distribute(full, sharding).to_local()


def zero_accumulated_grads(cfg: ModelConfig, model: nn.Module, batch: dict, n: int,
                           shardings: dict) -> tuple[dict, torch.Tensor]:
    """The ZeRO accumulator of a training cell: ``({name: DTensor laid out
    by shardings[name]}, loss)``. ``batch`` holds this rank's DP share of
    the microbatches ((n, b, ...); (b, ...) when ``n`` is 1); ``model``
    the whole weights. Microbatch by microbatch, each gradient is cast to
    ``cfg.grad_accum_dtype``, summed over the DP ranks and this rank's
    slice added to its shard. The sum is not divided: the caller divides
    by n x the DP width. The loss is the microbatches' mean, averaged over
    the DP ranks."""
    from torch.distributed.tensor import DTensor

    mesh = next(iter(shardings.values())).mesh
    dt = torch_dtype(cfg.grad_accum_dtype)
    accum, losses = {}, []
    for i in range(n):
        loss, grads = loss_and_grads(cfg, model, {k: v[i] for k, v in batch.items()}
                                     if n > 1 else batch)
        for k, g in grads.items():
            part = _slice(_dp_sum_(g.to(dt), mesh), shardings[k])
            if k not in accum:
                accum[k] = torch.zeros(part.shape, dtype=dt, device=part.device)
            accum[k] += part
        losses.append(loss)
        del grads
    loss = true_divide(_dp_sum_(torch.mean(torch.stack(losses)), mesh), float(_dp_size(mesh)))
    return ({k: DTensor.from_local(a, mesh, shardings[k].placements, run_check=False)
             for k, a in accum.items()}, loss)


def _zero_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, N: int, shardings: dict):
    from torch.distributed.tensor import DTensor

    gathered = _Gathered(cfg)
    mesh = next(iter(shardings.values())).mesh

    def train_step(params, opt_state, batch):
        local = {k: _local(v) for k, v in batch.items()}
        with gathered(params) as model:
            accum, loss = zero_accumulated_grads(cfg, model, local, max(N, 1), shardings)
        scale = float(max(N, 1) * _dp_size(mesh))
        grads = {k: DTensor.from_local(true_divide(a.to_local(), scale), mesh, a.placements,
                                       run_check=False) for k, a in accum.items()}
        del accum
        # the global norm: each leaf's float32 sum of squares over its shards
        sums = [torch.sum(torch.square(g.float())).full_tensor() for g in grads.values()]
        gnorm = torch.sqrt(torch.sum(torch.stack(sums)))
        mu, nu = opt_state["mu"], opt_state["nu"]
        # each weight's slice at its moments' layout, updated, then stored back
        p_local = {k: _relayout(p, mu[k].placements) for k, p in params.items()}
        _, new_state, metrics = adamw_update(
            {k: g.to_local() for k, g in grads.items()},
            {"mu": {k: m.to_local() for k, m in mu.items()},
             "nu": {k: v.to_local() for k, v in nu.items()},
             "step": opt_state["step"].to_local()},
            p_local, opt_cfg, grad_norm=gnorm)
        for k, p in params.items():
            _store(p, p_local[k], mu[k].placements)
        old = opt_state["step"]
        step = DTensor.from_local(new_state["step"], old.device_mesh, old.placements,
                                  run_check=False)
        return params, {"mu": mu, "nu": nu, "step": step}, {"loss": loss, **metrics}

    return train_step
