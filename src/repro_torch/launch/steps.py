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

* the weights are stored by their specs, and the step runs the reference's
  tensor-parallel compute plan on them
  (:mod:`repro_torch.parallel.tensor_parallel`, the counterpart of XLA's
  partitioning of the reference under ``with mesh:``): a model holds the
  rank's local shards (:class:`_Bound`), the step enters the mesh's
  context, and each layer computes on its shards (heads, FFN hidden,
  experts and vocab over "model" where the axis divides them) or gathers
  its leaves for its own call only (every DP-sharded dim, and every leaf
  of a layer that runs replicated), on the rank's share of the batch (its DP
  shard). No rank holds a whole weight that its spec shards, and only
  one layer's gathered leaves are live at a time (:func:`gathered_bytes`
  counts what the step holds beyond its arguments for the dry run);
* prefill and decode return the rows they compute, their logits gathered
  over "model" from the vocab-sharded head (only those rows) and over
  the DP axes;
* the training cell's gradient accumulator is kept DP-sharded (ZeRO,
  :func:`zero_accumulated_grads`): the backward gives each leaf's gradient
  on its local shard (summed over the DP axes that shard the leaf, FSDP),
  each microbatch's is cast to ``grad_accum_dtype``, summed over the other
  DP ranks in rank order and sliced to the moments' layout (an all-to-all:
  a reduce-scatter's bytes, in a fixed order) and added to the rank's
  shard, in microbatch order. AdamW then updates each moment shard and
  the matching slice of the weight, and the new weight is gathered back
  to its own layout;
* decode keeps each cache entry's DP batch shard and, where the attention
  computes on local kv heads, its heads; a sequence split (over "model"
  where the kv heads do not divide it, or over "data" at batch 1) stays
  split on a "model" axis of more than one rank: the layer writes the new
  row on the rank that holds its position and combines the ranks' partial
  softmaxes (split-KV decode). Every other sharded dim is gathered for its
  own layer only and its shard written back.

On a mesh whose "model" axis has one rank every layer runs its meshless
code, and on one rank every gather, reduction and slice is an identity in
value: a cell is bit-equal to the step without a mesh. On a larger
"model" axis the reordered float32 sums (row-parallel products, the
vocab-parallel loss) move results by rounding only."""

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


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _dp_split(t) -> tuple:
    """The DP axes of its mesh that split DTensor ``t`` (an input's batch)."""
    from repro_torch.parallel import tensor_parallel as TP

    dp = SH.dp_axes(t.device_mesh)
    return tuple(a for e in TP.spec_of(t) for a in TP.axes_of(e) if a in dp)


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_bytes(t: torch.Tensor, mesh, placements) -> int:
    """Bytes of this rank's shard of ``t`` laid out as ``placements``."""
    from torch.distributed.tensor import distribute_tensor

    return _bytes(distribute_tensor(t, mesh, placements, src_data_rank=None).to_local())


def _held_bytes(t: torch.Tensor, spec: tuple, sizes: dict, kept: set) -> int:
    """Bytes of ``t`` (whole) laid out by ``spec`` with only the (axis,
    dim) pairs of ``kept`` still split: what a rank holds of it once the
    rest is gathered, or 0 where nothing is gathered."""
    split = gathered = 1
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
            if (a, d) in kept:
                split *= sizes[a]
            else:
                gathered *= sizes[a]
    return _bytes(t) // split if gathered > 1 else 0


def _scope(name: str) -> str:
    """The layer whose call gathers leaf ``name``: its owner module (a
    block's attention, FFN or mixer, the embedding, the head)."""
    return name.rpartition(".")[0]


def gathered_bytes(cfg: ModelConfig, kind: str, args, shardings) -> dict[str, int]:
    """Bytes per device that a cell's step (``build_cell``'s ``args`` and
    ``shardings``, ``kind`` its shape's) holds beyond its arguments, by
    the plan its layers follow (``tensor_parallel.leaf_plan``):

    * ``params``: the largest layer's gathered leaves (the embedding, a
      block's attention, FFN or mixer, or the head: each gathers its own
      for its call only). A leaf gathers every DP dim and, unless its
      layer computes on its "model" shard, its "model" dim; a leaf used
      as stored counts nothing;
    * train, ``grads``: the backward's gradients, one per parameter on its
      local shard, in its parameter's type; ``accum``: the ZeRO
      accumulator, a shard of each by the moments' layout in
      ``grad_accum_dtype``;
    * decode, ``cache``: the largest layer's cache entries as the layer
      computes on them (:func:`~repro_torch.parallel.tensor_parallel.layer_cache`:
      the DP batch shard kept where the inputs' batch is DP-sharded, the
      heads kept where the attention computes on local kv heads, a
      sequence split kept where the layer's decode attends on the rank's
      rows (``tensor_parallel.kv_split``: a "model" axis of more than one
      rank, every entry of the layer split alike; MLA's absorbed decode),
      every other sharded dim gathered).

    Activations and other temporaries are not counted: with the arguments
    this is a lower bound of the step's peak."""
    from repro_torch.parallel import tensor_parallel as TP

    params, p_shard = args[0], shardings[0]
    mesh = next(iter(p_shard.values())).mesh
    sizes = SH.mesh_shape(mesh)
    scopes: dict[str, int] = {}
    with TP.context(mesh):
        for k, t in params.items():
            keep, _ = TP.leaf_plan(cfg, k)
            spec = tuple(p_shard[k].spec) + (None,) * (t.dim() - len(p_shard[k].spec))
            kept = {("model", keep % t.dim())} if keep is not None else set()
            scopes[_scope(k)] = scopes.get(_scope(k), 0) + _held_bytes(t, spec, sizes, kept)
        out = {"params": max(scopes.values(), default=0)}
        if kind == "train":
            mu, mu_shard = args[1]["mu"], shardings[1]["mu"]
            item = torch_dtype(cfg.grad_accum_dtype).itemsize
            out["grads"] = sum(_local_bytes(t, mesh, p_shard[k].placements)
                               for k, t in params.items())
            out["accum"] = sum(_local_bytes(t, mu_shard[k].mesh, mu_shard[k].placements)
                               // t.element_size() * item for k, t in mu.items())
        elif kind == "decode":
            inputs, b_shard, cache, c_shard = args[1], shardings[1], args[2], shardings[2]
            main = next(b_shard[k] for k in inputs if k in ("tokens", "codes", "embeds"))
            keep_dp = any(set(TP.axes_of(e)) & set(SH.dp_axes(mesh)) for e in main.spec)
            heads_local = (not cfg.use_mla and TP.splits(cfg.n_heads)
                           and TP.splits(cfg.n_kv_heads))
            # decode over a sequence-split cache keeps the split (TP.kv_split)
            split_kv = TP.model_size() > 1 and (not cfg.use_mla or cfg.mla_absorbed_decode)
            stacked = T.is_homogeneous(cfg)
            lead = 1 if stacked else 0
            by_layer: dict = {}

            def entry(path, t, s):
                spec = tuple(s.spec) + (None,) * (t.dim() - len(s.spec))
                layer = path.split("/")[0] if not stacked else ""
                by_layer.setdefault(layer, []).append((path.rsplit("/", 1)[-1], t, spec))

            SH.tree_map_with_path(lambda path, t: entry(path, t, _at(c_shard, path)), cache)
            layers: dict = {}
            for layer, items in by_layer.items():
                attn = all(name in _ATTN_ENTRIES for name, _, _ in items)
                seq = (TP.seq_axes([spec[lead:] for _, _, spec in items], sizes)
                       if split_kv and attn else ())
                for name, t, spec in items:
                    kept = {(a, lead) for a in SH.dp_axes(mesh)} if keep_dp else set()
                    if heads_local and name in ("k", "v"):
                        kept.add(("model", lead + 2))
                    kept |= {(a, lead + 1) for a in seq}
                    per = _held_bytes(t, spec, sizes, kept)
                    layers[layer] = layers.get(layer, 0) + (per // t.shape[0] if stacked else per)
            out["cache"] = max(layers.values(), default=0)
    return out


# a decode cache's attention entries: their dim 1 is the sequence
_ATTN_ENTRIES = ("k", "v", "k_scale", "v_scale", "c_kv", "k_rope")


def _at(tree, path: str):
    """The leaf of ``tree`` at ``path`` (keys and indices joined by "/")."""
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, (tuple, list)) else tree[key]
    return tree


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` are the same elements of one storage (also for
    ``meta`` tensors, whose data pointers are all 0)."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset() and a.shape == b.shape
            and a.stride() == b.stride())


def _store(t, local: torch.Tensor, spec: tuple | None = None) -> None:
    """Write ``local`` (laid out by ``spec``, a finer layout than DTensor
    ``t``'s; default: ``t``'s own) into ``t``, gathering what ``t`` holds
    whole (``tensor_parallel.gather_to``: host-staged collectives)."""
    from repro_torch.parallel import tensor_parallel as TP

    mine = t.to_local()
    if _same_memory(local, mine):
        return  # the step wrote the shard in place
    if spec is not None:
        local = TP.gather_to(local, t.device_mesh, spec, TP.spec_of(t))
    mine.copy_(local)


def _gather_rows(x: torch.Tensor, like) -> torch.Tensor:
    """Rows of ``x`` (dim 0) computed on the DP batch shard of the input
    DTensor ``like``, gathered whole over its DP axes."""
    from repro_torch.parallel import tensor_parallel as TP

    return TP.gather_to(x, like.device_mesh, (_dp_split(like) or None,), (None,))


class _Bound:
    """A ``Transformer`` whose parameter slots hold a cell's local shards,
    each with its layout (``tensor_parallel.bind``), for the duration of a
    ``with`` block, under the tensor-parallel context of the weights'
    mesh; its slots are emptied on exit. The template is built once, when
    the step is made (under ``FakeTensorMode`` on the CPU: nothing is
    allocated, and a model's device is its weights', all of which are
    replaced), so that no count of a step sees it."""

    def __init__(self, cfg: ModelConfig):
        from torch._subclasses.fake_tensor import FakeTensorMode

        self.cfg = cfg
        with FakeTensorMode():
            self.model = T.Transformer(cfg, device="cpu")

    @contextmanager
    def __call__(self, params: dict, batch_dp: bool, cache=None):
        from repro_torch.parallel import tensor_parallel as TP

        first = next(iter(params.values()))
        TP.bind(self.model, params)
        try:
            with TP.context(first.device_mesh, batch_dp, cache,
                            stacked=T.is_homogeneous(self.cfg)):
                yield self.model
        finally:
            for name in params:
                owner, _, leaf = name.rpartition(".")
                self.model.get_submodule(owner)._parameters[leaf] = None


def _main_input(inputs: dict):
    return next(v for k, v in inputs.items() if k in ("tokens", "codes", "embeds"))


def _whole_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Logits as the meshless step returns them: vocab-sharded ones (the
    rows a step returns) gathered over "model"."""
    from repro_torch.parallel import tensor_parallel as TP

    if TP.vocab_sharded(cfg):
        return TP.gather_vocab(logits, cfg.n_codebooks, cfg.vocab_padded)
    return logits


def _sharded_prefill_step(cfg: ModelConfig):
    step, bound = make_prefill_step(cfg), _Bound(cfg)

    def prefill_step(params, batch):
        main = _main_input(batch)
        with bound(params, bool(_dp_split(main))) as model:
            logits = _whole_logits(cfg, step(model, {k: _local(v) for k, v in batch.items()}))
        return _gather_rows(logits, main)

    return prefill_step


def _sharded_decode_step(cfg: ModelConfig):
    step, bound = make_decode_step(cfg), _Bound(cfg)

    def decode_step(params, inputs, cache):
        main = _main_input(inputs)
        local = SH.tree_map(_local, cache)
        with bound(params, bool(_dp_split(main)), cache) as model:
            logits, new = step(model, {k: _local(v) for k, v in inputs.items()}, local)
            logits = _whole_logits(cfg, logits)
        SH.tree_map(_store, cache, new)
        return _gather_rows(logits, main), cache

    return decode_step


def _dp_sum_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the DP ranks of ``mesh`` in place (one ``all_reduce``
    per DP mesh dim of more than one rank)."""
    from repro_torch.parallel import tensor_parallel as TP

    return TP.reduce_axes_(t, mesh, SH.dp_axes(mesh))


def zero_accumulated_grads(cfg: ModelConfig, params: dict, batch: dict, n: int,
                           shardings: dict, bound: _Bound | None = None
                           ) -> tuple[dict, torch.Tensor]:
    """The ZeRO accumulator of a training cell: ``({name: DTensor laid out
    by shardings[name]}, loss)``. ``params`` are the cell's weights
    (``{name: DTensor}``), ``batch`` this rank's DP share of the
    microbatches ((n, b, ...); (b, ...) when ``n`` is 1). Microbatch by
    microbatch the model runs tensor-parallel on the local shards, each
    gradient (on its leaf's local shard) is cast to
    ``cfg.grad_accum_dtype``, summed over the DP ranks in rank order into
    the moments' layout (``tensor_parallel.dp_sum_to``) and added to this
    rank's shard. The sum is not divided: the caller divides by n x the DP
    width. The loss is the microbatches' mean, averaged over the DP
    ranks. ``bound``: the step's model template (default: a new one)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel import tensor_parallel as TP

    mesh = next(iter(shardings.values())).mesh
    dt = torch_dtype(cfg.grad_accum_dtype)
    accum, losses = {}, []
    have = {k: TP.spec_of(p) for k, p in params.items()}
    bound = bound or _Bound(cfg)
    with bound(params, batch_dp=True) as model:
        for i in range(n):
            loss, grads = loss_and_grads(cfg, model, {k: v[i] for k, v in batch.items()}
                                         if n > 1 else batch)
            for k, g in grads.items():
                part = TP.dp_sum_to(g.to(dt), mesh, have[k], shardings[k].spec)
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

    from repro_torch.parallel import tensor_parallel as TP

    mesh = next(iter(shardings.values())).mesh
    bound = _Bound(cfg)

    def train_step(params, opt_state, batch):
        local = {k: _local(v) for k, v in batch.items()}
        accum, loss = zero_accumulated_grads(cfg, params, local, max(N, 1), shardings, bound)
        scale = float(max(N, 1) * _dp_size(mesh))
        grads = {k: DTensor.from_local(true_divide(a.to_local(), scale), mesh, a.placements,
                                       run_check=False) for k, a in accum.items()}
        del accum
        # the global norm: each leaf's float32 sum of squares over its shards
        sums = [TP.reduce_axes_(torch.sum(torch.square(g.to_local().float())), mesh,
                                [a for e in TP.spec_of(g) for a in TP.axes_of(e)])
                for g in grads.values()]
        gnorm = torch.sqrt(torch.sum(torch.stack(sums)))
        mu, nu = opt_state["mu"], opt_state["nu"]
        # each weight's slice at its moments' layout, updated, then stored back
        want = {k: TP.spec_of(mu[k]) for k in params}
        p_local = {k: TP.take_shard(p.to_local(), mesh, TP.spec_of(p), want[k])
                   for k, p in params.items()}
        _, new_state, metrics = adamw_update(
            {k: g.to_local() for k, g in grads.items()},
            {"mu": {k: m.to_local() for k, m in mu.items()},
             "nu": {k: v.to_local() for k, v in nu.items()},
             "step": opt_state["step"].to_local()},
            p_local, opt_cfg, grad_norm=gnorm)
        for k, p in params.items():
            _store(p, p_local[k], want[k])
        old = opt_state["step"]
        step = DTensor.from_local(new_state["step"], old.device_mesh, old.placements,
                                  run_check=False)
        return params, {"mu": mu, "nu": nu, "step": step}, {"loss": loss, **metrics}

    return train_step
