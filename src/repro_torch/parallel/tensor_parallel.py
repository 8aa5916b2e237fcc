"""Tensor-parallel compute over a mesh's "model" axis: the port's counterpart
of the reference's ambient ``with mesh:`` and of its sharding constraints
(``layers.constrain`` / ``constrain_param``, ``transformer.maybe_constrain_act``
/ ``maybe_constrain_logits``), from which XLA partitions the reference's
compute.

A cell's step (``launch.steps.build_cell``) enters :func:`context` on its
``DeviceMesh`` and lets a model hold the rank's local shards, each with its
layout (:func:`bind`). The layers read the context and follow the
reference's rule: a dim goes to "model" only where the axis size m divides
it, else it stays replicated. So:

* the embedding table is stored d-sharded: each rank looks its columns up
  and :func:`gather_from_model` makes the block boundary (B_dp, S, D),
  replicated over "model" as ``maybe_constrain_act`` pins it;
* attention splits q heads over "model" where m divides H (k/v heads too
  where m divides Hkv; else k/v come whole from weights gathered for the
  block and a rank keeps the kv heads its q heads read), runs the attention
  core on its local heads and ``wo`` row-parallel; where m does not divide
  H the whole attention runs replicated from gathered weights;
* the MLP runs column-parallel on f (``w_in``, ``w_gate``) and row-parallel
  (``w_out``) where m divides f;
* the MoE keeps its experts on "model" where m divides E (expert
  parallelism: every rank routes the same tokens, runs the experts it
  holds and the float32 partial combines are summed over "model"), else
  each expert's f where m divides it; the router stays whole;
* the LM head gives vocab-sharded logits where m divides the padded vocab
  (:func:`vocab_sharded`): serving gathers only the rows it returns
  (:func:`gather_vocab`), training takes a vocab-parallel cross entropy
  (:func:`cross_entropy`);
* every other layer (MLA, the recurrent mixers, a tied head) gathers
  its leaves and runs replicated.

Decode attention over a cache entry whose sequence dim is split (over
"model" where the kv heads do not divide it, over "data" where the batch
does not divide the DP width) never gathers it (:func:`kv_split`): the
rank writes the new row where it holds its position, scores its own rows
and the partial softmaxes are combined by all-reduces of the row max, the
sum of exponentials and the float32 P·V partial over the axes that split
the sequence, as XLA partitions the reference's decode (flash-decoding's
split-KV pattern). Where the sequence is split over "model" and the q
heads are too, q is gathered over the heads first and the rank keeps its
own heads of the result.

The collectives are ``torch.autograd.Function``\\s:

* ``copy_to_model``: identity forward, ``all_reduce`` over "model" backward,
  in float32 (the input of a column-parallel region);
* ``reduce_from_model``: ``all_reduce`` forward, identity backward (the
  output of a row-parallel region). Row-parallel partial products are
  formed in float32 (:func:`row_parallel`), summed over "model" in float32
  and rounded once to the activation type (:func:`reduce`), as the
  reference's ``preferred_element_type=float32`` products are;
* ``gather_from_model``: an all-gather over "model" on one dim, whose
  backward takes the rank's slice;
* the leaf gather (:func:`gathered`): a layer's leaves laid out as its
  computation needs them, for the layer's own call only: every DP dim
  (FSDP) gathered, the "model" dim kept where the layer computes on its
  shard, else gathered. Its backward sums over the DP axes it gathered and
  takes the slice; over "model" it sums where each rank used part of the
  whole leaf (k/v computed whole for some heads) and only slices where
  every rank computed the same from it (a replicated layer).

Only one layer's gathered leaves are live at a time: a gathered leaf that
autograd would save for the backward is saved as a token and gathered again
when the backward reads it (``saved_tensors_hooks``), and inside a
checkpointed block (``cfg.remat``) the recompute gathers again, so no
gathered weight outlives its layer's call.

Outside a context every function here is the identity and every layer runs
its meshless code, bit for bit. On a mesh whose "model" axis has size 1
the layers run their meshless code too; only DP-sharded (FSDP) leaves are
gathered, which is exact.

Host staging: ranks that share one card take gloo (NCCL refuses two ranks
of a communicator on one GPU), and gloo's CUDA forms cover only some
collectives. So every collective on a CUDA tensor over a gloo group copies
it to the host, runs there and copies the result back. Staging moves
bytes, not compute: every product still runs on the card. NCCL groups
(one rank a card) take the tensors directly, as does the ``fake`` backend
of the dry run (no data, nothing staged), whose op counter sees every
collective here: each is a c10d op that reaches the dispatcher.
"""

from __future__ import annotations

import math
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

__all__ = ["Partial", "SeqSplit", "TPContext", "attention_plan", "axes_of", "bind", "context",
           "copy_to_model", "cross_entropy", "current", "embed_plan", "gather_from_model",
           "gather_vocab", "gathered", "head_plan", "hooks_off", "kv_heads", "kv_split",
           "layer_cache", "leaf_plan", "local_state", "mlp_plan", "model_size", "moe_plan",
           "reduce", "reduce_axes_", "reduce_from_model", "residual", "row_parallel", "seq_axes",
           "spec_of", "splits", "vocab_sharded"]

DP_AXES = ("pod", "data")


@dataclass
class TPContext:
    """The mesh a step runs on, as the layers read it."""

    mesh: object
    sizes: dict  # {axis: size}, in the mesh's order
    coords: dict  # {axis: this rank's coordinate}
    batch_dp: bool = True  # the inputs' batch dim is sharded over the DP axes
    cache: dict = field(default_factory=dict)  # storage key -> per-layer spec
    hooks: bool = True  # save gathered leaves as tokens (off inside checkpoints)

    @property
    def m(self) -> int:
        return self.sizes.get("model", 1)

    def group(self, axis: str):
        return self.mesh.get_group(axis)


_STACK: list[TPContext] = []


def current() -> TPContext | None:
    return _STACK[-1] if _STACK else None


def model_size() -> int:
    ctx = current()
    return 1 if ctx is None else ctx.m


def splits(n: int) -> bool:
    """A dim of size ``n`` goes to "model": the axis has more than one rank
    and divides it (the reference's ``constrain``)."""
    m = model_size()
    return m > 1 and n % m == 0


def axes_of(entry) -> tuple:
    """The mesh axes a spec entry names (an axis, a tuple of axes, or None)."""
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def spec_of(t) -> tuple:
    """A DTensor's layout as a spec: one entry per dim, the mesh axes that
    shard it (major first), or None."""
    from torch.distributed.tensor import Shard

    names = t.device_mesh.mesh_dim_names
    spec = [()] * t.dim()
    for name, p in zip(names, t.placements):
        if isinstance(p, Shard):
            spec[p.dim] = spec[p.dim] + (name,)
    return tuple(None if not e else e[0] if len(e) == 1 else e for e in spec)


@contextmanager
def context(mesh, batch_dp: bool = True, cache=None, stacked: bool = False):
    """The layers under the block compute tensor-parallel on ``mesh`` (a
    ``DeviceMesh`` with a "model" axis). ``batch_dp``: the inputs' batch
    dim is DP-sharded, so a cache entry keeps its DP shard. ``cache``: a
    decode cache of DTensors, its entries' layouts registered for
    :func:`layer_cache` (``stacked``: a homogeneous stack's (L, ...)
    entries, whose layer dim no rule shards)."""
    from repro_torch.parallel.sharding import mesh_shape, tree_map

    sizes = mesh_shape(mesh)
    ctx = TPContext(mesh, sizes, dict(zip(sizes, mesh.get_coordinate())), batch_dp)
    if cache is not None:
        def register(t):
            spec = spec_of(t)
            if stacked:
                if any(sizes[a] > 1 for a in axes_of(spec[0])):
                    raise ValueError(f"a rule shards a cache entry's layer dim: {spec}")
                spec = spec[1:]
            ctx.cache[t.to_local().untyped_storage()._cdata] = spec

        tree_map(register, cache)
    _STACK.append(ctx)
    try:
        yield ctx
    finally:
        _STACK.remove(ctx)


@contextmanager
def hooks_off():
    """Inside a checkpointed function: the checkpoint keeps nothing and its
    recompute gathers again, so gathered leaves are not tokenised."""
    ctx = current()
    if ctx is None:
        yield
        return
    was, ctx.hooks = ctx.hooks, False
    try:
        yield
    finally:
        ctx.hooks = was


def bind(module: torch.nn.Module, params: dict) -> None:
    """Let ``module``'s parameter slots hold the local tensors of ``params``
    (``{name: DTensor}``, the module's names), each with its layout for the
    layers to read. The module keeps whatever it held under other names."""
    for name, t in params.items():
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner)
        with torch.no_grad():  # the local tensor itself, a leaf, not a view of it
            mod._parameters[leaf] = t.to_local()
        mod.__dict__.setdefault("_tp_specs", {})[leaf] = spec_of(t)


# --------------------------------------------------------------------------
# collectives (host-staged on CUDA tensors over gloo)
# --------------------------------------------------------------------------


def _staged(t: torch.Tensor, group) -> bool:
    import torch.distributed as dist

    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _on_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of CUDA tensor ``t`` in pinned host memory (the caching host
    allocator's: a copy at the link's rate, and no allocation once warm)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _all_reduce_(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """Reduce ``t`` (contiguous) over ``group`` in place."""
    import torch.distributed as dist

    op = dist.ReduceOp.SUM if op is None else op
    if _staged(t, group):
        h = _on_host(t)
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def _pieces(t: torch.Tensor, group, n: int) -> list:
    """Every rank's ``t`` of ``group`` (``n`` ranks), in group rank order."""
    import torch.distributed as dist

    src = t.contiguous()
    staged = _staged(src, group)
    if staged:
        src = _on_host(src)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts] if staged else parts


def _all_gather(t: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated on ``dim`` in group rank order (the
    mesh's coordinate order)."""
    if n == 1:
        return t
    return torch.cat(_pieces(t, group, n), dim=dim)


def _all_to_all(t: torch.Tensor, group, n: int, dim: int) -> list:
    """``t`` cut into ``n`` chunks on ``dim``, chunk j sent to group rank j:
    the chunks of this rank's index that each rank sends, in rank order."""
    import torch.distributed as dist

    x = t.movedim(dim, 0).contiguous()
    staged = _staged(x, group)
    src = _on_host(x) if staged else x
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    out = out.to(t.device) if staged else out
    return [c.movedim(0, dim) for c in out.chunk(n, dim=0)]


def ordered_sum(parts: list) -> torch.Tensor:
    """``((p0 + p1) + p2) + ...``: a sum over ranks in rank order."""
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return acc


def dp_sum_to(g: torch.Tensor, mesh, have: tuple, want: tuple) -> torch.Tensor:
    """``g`` summed over the DP axes of ``mesh`` that ``have`` (its spec)
    does not shard, each in rank order, landing in the layout ``want``
    shards over those axes: on a dim ``want`` shards over an axis, each
    rank receives its chunk from every rank (an all-to-all: the bytes of a
    reduce-scatter); elsewhere it gathers every rank's ``g``. A fixed order,
    so that the sum is the same as one summed in one process rank by rank."""
    from repro_torch.parallel.sharding import mesh_shape

    sizes = mesh_shape(mesh)
    have_axes = {a for e in have for a in axes_of(e)}
    for a in DP_AXES:
        n = sizes.get(a, 1)
        if n == 1 or a in have_axes:
            continue
        dims = [d for d, e in enumerate(want) if a in axes_of(e)]
        group = mesh.get_group(a)
        parts = _all_to_all(g, group, n, dims[0]) if dims else _pieces(g, group, n)
        g = ordered_sum(parts)
    return g


def reduce_axes_(t: torch.Tensor, mesh, axes, op=None) -> torch.Tensor:
    """Sum (or reduce by ``op``, a ``ReduceOp``) contiguous ``t`` in place
    over each of ``axes`` of ``mesh`` (one ``all_reduce`` per axis of more
    than one rank)."""
    from repro_torch.parallel.sharding import mesh_shape

    sizes = mesh_shape(mesh)
    for a in axes:
        if sizes[a] > 1:
            _all_reduce_(t, mesh.get_group(a), op)
    return t


def take_shard(local: torch.Tensor, mesh, have: tuple, want: tuple) -> torch.Tensor:
    """This rank's block of ``local`` (laid out by spec ``have``) in the
    finer layout ``want``: a view, each (axis, dim) that ``want`` adds
    narrowed to the rank's coordinate, major axis first."""
    from repro_torch.parallel.sharding import mesh_shape

    sizes, coords = mesh_shape(mesh), dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for d, entry in enumerate(want):
        for a in axes_of(entry):
            if a not in axes_of(have[d]) and sizes[a] > 1:
                size = local.shape[d] // sizes[a]
                local = local.narrow(d, coords[a] * size, size)
    return local


def gather_to(local: torch.Tensor, mesh, have: tuple, want: tuple) -> torch.Tensor:
    """``local`` (laid out by spec ``have``) gathered into the coarser
    layout ``want``: every (axis, dim) of ``have`` that ``want`` lacks
    gathered, minor axis first."""
    from repro_torch.parallel.sharding import mesh_shape

    sizes = mesh_shape(mesh)
    for d, entry in enumerate(have):
        for a in reversed(axes_of(entry)):
            if a not in axes_of(want[d]) and sizes[a] > 1:
                local = _all_gather(local, mesh.get_group(a), sizes[a], d)
    return local


# --------------------------------------------------------------------------
# autograd functions
# --------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # each rank's share of the input's gradient, summed in float32
        total = g.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        return _all_reduce_(total, ctx.group).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.mark_dirty(x)
        return _all_reduce_(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, rank, dim):
        ctx.args = (n, rank, dim)
        return _all_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        n, rank, dim = ctx.args
        size = g.shape[dim] // n
        return g.narrow(dim, rank * size, size).contiguous(), None, None, None, None


class _F32Matmul(torch.autograd.Function):
    """``x @ w`` formed in float32 from operands of any float type; saves
    the operands in their own types (a gathered leaf stays a token)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if w.dim() > 2:  # a stack of products (the experts' (E, f, d) against (E, n, f))
            if ctx.needs_input_grad[0]:
                dx = torch.matmul(g, w.float().mT).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dw = torch.matmul(x.float().mT, g).to(w.dtype)
            return dx, dw
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(g, w.float().T).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.float().reshape(-1, x.shape[-1]).T,
                              g.reshape(-1, g.shape[-1])).to(w.dtype)
        return dx, dw


class _Plan(NamedTuple):
    """How a leaf is laid out for its layer: the (axis, dim) gathers in
    order (minor axis first within a dim) and the axes its gradient is
    summed over."""

    gathers: tuple
    reduce: frozenset


def _leaf_forward(t: torch.Tensor, plan: _Plan, ctx: TPContext) -> torch.Tensor:
    for axis, dim in plan.gathers:
        t = _all_gather(t, ctx.group(axis), ctx.sizes[axis], dim)
    return t


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, plan, tp):
        ctx.plan, ctx.tp, ctx.shape = plan, tp, t.shape
        return _leaf_forward(t, plan, tp)

    @staticmethod
    def backward(ctx, g):
        plan, tp = ctx.plan, ctx.tp
        g = g.contiguous()
        gathered = set()
        for axis, dim in reversed(plan.gathers):
            if axis in plan.reduce:
                g = _all_reduce_(g, tp.group(axis))
            size = g.shape[dim] // tp.sizes[axis]
            g = g.narrow(dim, tp.coords[axis] * size, size).contiguous()
            gathered.add(axis)
        for axis in sorted(plan.reduce - gathered):
            g = _all_reduce_(g, tp.group(axis))
        return g, None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    ctx = current()
    if ctx is None or ctx.m == 1:
        return x
    return _CopyToModel.apply(x, ctx.group("model"))


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a fresh tensor, reduced in place) summed over "model"."""
    ctx = current()
    if ctx is None or ctx.m == 1:
        return x
    return _ReduceFromModel.apply(x.contiguous(), ctx.group("model"))


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    ctx = current()
    if ctx is None or ctx.m == 1:
        return x
    return _GatherFromModel.apply(x, ctx.group("model"), ctx.m, ctx.coords["model"],
                                  dim % x.dim())


class Partial(NamedTuple):
    """A row-parallel output: this rank's float32 partial sum over "model"."""

    value: torch.Tensor


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> Partial:
    """``x`` (…, k_local) times ``w`` (k_local, n), or a stack (E, …,
    k_local) times (E, k_local, n), in float32: this rank's share of a
    product whose reduction dim is split over "model"."""
    return Partial(_F32Matmul.apply(x, w))


def reduce(part: Partial, dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel output summed over "model" in float32, rounded once."""
    return reduce_from_model(part.value).to(dtype)


def residual(x: torch.Tensor, *branches) -> torch.Tensor:
    """``x`` plus the branches in order (``x + a + f``); row-parallel
    partials among them are summed in float32 first and reduced over
    "model" once (the parallel residual's attention and FFN)."""
    parts = [b.value for b in branches if isinstance(b, Partial)]
    if not parts:
        out = x
        for b in branches:
            out = out + b
        return out
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    out = x + reduce(Partial(total), x.dtype)
    for b in branches:
        if not isinstance(b, Partial):
            out = out + b
    return out


# --------------------------------------------------------------------------
# leaves: what each layer keeps on "model"
# --------------------------------------------------------------------------


def attention_plan(n_heads: int, n_kv_heads: int) -> tuple[dict, tuple]:
    """``(keep, partial)`` of a GQA attention layer: q heads and ``wo``'s
    rows on "model" where m divides H, k/v heads too where m divides Hkv
    (else k/v whole, their gradient summed over "model"); nothing where m
    does not divide H (the layer runs replicated)."""
    if not splits(n_heads):
        return {}, ()
    if splits(n_kv_heads):
        return {"wq": -2, "wk": -2, "wv": -2, "wo": -2}, ()
    return {"wq": -2, "wo": -2}, ("wk", "wv")


def mlp_plan(d_ff: int) -> tuple[dict, tuple]:
    if not splits(d_ff):
        return {}, ()
    return {"w_in": -1, "w_gate": -1, "w_out": -2}, ()


def moe_plan(n_experts: int, d_ff: int) -> tuple[dict, tuple]:
    """``(keep, partial)`` of a MoE layer: the experts (dim -3 of the
    stacks) on "model" where m divides E; else each expert's f (``w_in``
    and ``w_gate`` column-parallel, ``w_out`` row-parallel) where m
    divides f, as the sharding rule falls through; nothing where neither
    divides (the layer runs replicated). The router stays whole and its
    gradient is summed over "model": each rank's combine reads only its
    own experts' (or f columns') share of the gates."""
    if splits(n_experts):
        return {"w_in": -3, "w_gate": -3, "w_out": -3}, ("router",)
    if splits(d_ff):
        return {"w_in": -1, "w_gate": -1, "w_out": -2}, ("router",)
    return {}, ()


def embed_plan(d_model: int) -> tuple[dict, tuple]:
    return ({"table": -1}, ()) if splits(d_model) else ({}, ())


def head_plan(padded: int, tied: bool) -> tuple[dict, tuple]:
    return ({"w": -1}, ()) if splits(padded) and not tied else ({}, ())


def leaf_plan(cfg, name: str) -> tuple[int | None, bool]:
    """``(the dim kept on "model" or None, gradient summed over "model")``
    of the model's leaf ``name`` under the current context: the plans the
    layers follow, by the leaf's name (for what a step holds, before it
    runs)."""
    owner, _, leaf = name.rpartition(".")
    kind = owner.rpartition(".")[2]
    if name == "embed.table":
        keep, partial = embed_plan(cfg.d_model)
    elif name == "lm_head.w":
        keep, partial = head_plan(cfg.vocab_padded, cfg.tie_embeddings)
    elif kind == "attn" and not cfg.use_mla:
        keep, partial = attention_plan(cfg.n_heads, cfg.n_kv_heads)
    elif kind == "ff":
        keep, partial = (moe_plan(cfg.n_experts, cfg.d_ff) if cfg.is_moe else mlp_plan(cfg.d_ff))
    else:
        keep, partial = {}, ()
    return keep.get(leaf), leaf in partial


def _plan_for(ctx: TPContext, spec: tuple, keep: int | None, partial: bool,
              ndim: int) -> _Plan | None:
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    keep = None if keep is None or ctx.m == 1 else keep % ndim
    gathers, kept = [], False
    for d, entry in enumerate(spec):
        for a in reversed(axes_of(entry)):
            if a == "model" and d == keep:
                kept = True
            elif ctx.sizes[a] > 1:
                gathers.append((a, d))
    if keep is not None and not kept:
        # the sharding rules split a dim over "model" exactly where the plan
        # computes on it in shards (tests/test_torch_tensor_parallel.py)
        raise ValueError(f"a leaf laid out as {spec}, not split over 'model' on dim {keep}, "
                         f"which its layer computes on in shards")
    reduce = {a for a, _ in gathers if a != "model"}
    if partial and ctx.m > 1:
        reduce.add("model")
    if not gathers and not reduce:
        return None
    return _Plan(tuple(gathers), frozenset(reduce))


class _Token(NamedTuple):
    index: int
    size: tuple
    stride: tuple
    offset: int


@contextmanager
def gathered(module: torch.nn.Module, plan: tuple[dict, tuple] = ({}, ())):
    """For the block, the leaves of ``module`` (and its submodules) that
    :func:`bind` gave a layout are laid out as ``plan`` (``(keep,
    partial)``: the dim each named leaf keeps on "model", and the leaves
    whose gradient each rank computes in part); every other leaf whole.
    On exit the module holds its local shards again. Under autograd the
    gathered leaves are saved as tokens, gathered again by the backward."""
    ctx = current()
    if ctx is None:
        yield module
        return
    keep, partial = plan
    made = []
    for prefix, mod in module.named_modules():
        specs = mod.__dict__.get("_tp_specs")
        for leaf, spec in (specs or {}).items():
            name = f"{prefix}.{leaf}" if prefix else leaf
            local = mod._parameters[leaf]
            p = _plan_for(ctx, spec, keep.get(name), name in partial, local.dim())
            if p is not None:
                made.append((mod, leaf, local, p, _GatherLeaf.apply(local, p, ctx)))
    if not made:
        yield module
        return
    # the hooks hold the local leaves and their plans, never a gathered tensor
    sources = [(local, p) for _, _, local, p, _ in made]
    tokens = {full.untyped_storage()._cdata: i for i, (_, _, _, p, full) in enumerate(made)
              if p.gathers}

    def pack(t):
        i = tokens.get(t.untyped_storage()._cdata)
        if i is None:
            return t
        return _Token(i, tuple(t.size()), t.stride(), t.storage_offset())

    def unpack(x):
        if not isinstance(x, _Token):
            return x
        local, p = sources[x.index]
        with torch.no_grad():
            full = _leaf_forward(local, p, ctx)
        return full.as_strided(x.size, x.stride, x.offset)

    hooks = (torch.autograd.graph.saved_tensors_hooks(pack, unpack)
             if ctx.hooks and tokens and torch.is_grad_enabled() else nullcontext())
    try:
        for mod, leaf, _, _, full in made:
            mod._parameters[leaf] = full
        with hooks:
            yield module
    finally:
        for mod, leaf, local, _, _ in made:
            mod._parameters[leaf] = local
        made.clear()


def kv_heads(n_heads: int, n_kv_heads: int):
    """The kv heads this rank's q heads read (GQA's ``h // group`` over its
    global q-head indices): a slice where each kv head serves the same
    number of consecutive local q heads, else the index list (one kv head
    per q head)."""
    ctx = current()
    local = n_heads // ctx.m
    group = n_heads // n_kv_heads
    first_q = ctx.coords["model"] * local
    idx = [(first_q + j) // group for j in range(local)]
    n = idx[-1] - idx[0] + 1
    if local % n == 0 and idx == [idx[0] + j // (local // n) for j in range(local)]:
        return slice(idx[0], idx[0] + n)
    return idx


# --------------------------------------------------------------------------
# decode caches: one layer's entries at a time
# --------------------------------------------------------------------------


def _entry_plan(ctx: TPContext, t: torch.Tensor, heads: bool, seq: tuple = ()):
    """(the per-layer spec of a cache entry, its (axis, dim) gathers, the
    dim narrowed to the local heads or None). ``seq``: the axes whose split
    of the sequence dim (1) the layer keeps (:func:`kv_split`)."""
    spec = ctx.cache.get(t.untyped_storage()._cdata)
    if spec is None:
        return None, (), None
    keep_dp = ctx.batch_dp
    gathers = []
    for d, entry in enumerate(spec):
        for a in reversed(axes_of(entry)):
            kept = ((a in DP_AXES and d == 0 and keep_dp) or (a == "model" and d == 2 and heads)
                    or (d == 1 and a in seq))
            if not kept and ctx.sizes[a] > 1:
                gathers.append((a, d))
    model_on_heads = len(spec) > 2 and "model" in axes_of(spec[2])
    narrow = 2 if heads and ctx.m > 1 and not model_on_heads and t.dim() > 2 else None
    return spec, tuple(gathers), narrow


def seq_axes(specs, sizes: dict) -> tuple:
    """The mesh axes (of more than one rank) that split the sequence dim (1)
    of every one of a layer's attention cache entries (per-layer ``specs``),
    where all of them are split alike; else ``()``: the entries are then
    gathered for the layer."""
    found = {tuple(a for a in axes_of(s[1] if len(s) > 1 else None) if sizes[a] > 1)
             for s in specs}
    return found.pop() if len(found) == 1 else ()


class SeqSplit(NamedTuple):
    """A decode cache's sequence split over mesh ``axes`` (major first):
    this rank holds rows [first, first + its rows)."""

    axes: tuple
    first: int


def kv_split(cache) -> SeqSplit | None:
    """Where one layer's attention cache entries (a dict of local tensors)
    all have their sequence split alike over axes of more than one rank:
    those axes and this rank's first row. The layer's decode then attends
    on its own rows and never gathers them. None outside a context, on a
    "model" axis of one rank (where every layer runs its meshless code:
    the entries are gathered, which is exact), without a registered
    cache, or where the entries are not split so."""
    ctx = current()
    if ctx is None or ctx.m == 1 or cache is None or not ctx.cache:
        return None
    specs = [ctx.cache.get(t.untyped_storage()._cdata) for t in cache.values()]
    if any(s is None for s in specs):
        return None
    axes = seq_axes(specs, ctx.sizes)
    if not axes:
        return None
    index = 0
    for a in axes:
        index = index * ctx.sizes[a] + ctx.coords[a]
    return SeqSplit(axes, index * next(iter(cache.values())).shape[1])


@contextmanager
def layer_cache(cache, heads: bool = False, write_back: bool = True,
                split: SeqSplit | None = None):
    """One layer's cache entries (a dict of local tensors, or None) laid out
    as the layer computes on them: each entry's DP batch shard kept where
    the inputs' batch is DP-sharded, its heads (dim 2) kept on "model"
    where ``heads`` (narrowed to the rank's heads where the entry is not
    split by heads), its sequence split kept where ``split`` (the layer's
    :func:`kv_split`: written and read in place), every other sharded dim
    gathered for this layer only. On exit each gathered entry's shard is
    written back (``write_back``)."""
    ctx = current()
    if ctx is None or cache is None or not ctx.cache:
        yield cache
        return
    seq = split.axes if split is not None else ()
    out, back = {}, []
    for k, t in cache.items():
        _, gathers, narrow = _entry_plan(ctx, t, heads, seq)
        full = t
        for axis, dim in gathers:
            full = _all_gather(full, ctx.group(axis), ctx.sizes[axis], dim)
        if gathers:
            back.append((t, full, gathers))
        if narrow is not None:
            size = full.shape[narrow] // ctx.m
            full = full.narrow(narrow, ctx.coords["model"] * size, size)
        out[k] = full
    try:
        yield out
    finally:
        if write_back:
            for t, full, gathers in back:
                t.copy_(_take_shard(ctx, full, gathers))


def _take_shard(ctx: TPContext, full: torch.Tensor, gathers) -> torch.Tensor:
    for axis, dim in reversed(gathers):
        size = full.shape[dim] // ctx.sizes[axis]
        full = full.narrow(dim, ctx.coords[axis] * size, size)
    return full


def local_state(new, old):
    """A recurrent layer's new state (whole, as :func:`layer_cache` gave
    it) laid out as its old state's local tensors: the rank's shard of
    each entry."""
    ctx = current()
    if ctx is None or new is None or old is None or not ctx.cache:
        return new
    return {k: _take_shard(ctx, v, _entry_plan(ctx, old[k], False)[1]) for k, v in new.items()}


# --------------------------------------------------------------------------
# vocab-sharded logits
# --------------------------------------------------------------------------


def vocab_sharded(cfg) -> bool:
    """The LM head returns this rank's vocab shard of the logits: the
    fused (codebooks x padded vocab) columns it holds, (..., n_codebooks x
    Vp / m), padded slots masked by their global index."""
    return splits(cfg.vocab_padded) and not cfg.tie_embeddings


def gather_vocab(local: torch.Tensor, n_codebooks: int, padded: int) -> torch.Tensor:
    """Vocab-sharded logits whole: (..., Vp), or (..., n_codebooks, Vp)."""
    ctx = current()
    whole = _all_gather(local, ctx.group("model"), ctx.m, local.dim() - 1)
    return whole.reshape(*whole.shape[:-1], n_codebooks, padded) if n_codebooks else whole


def cross_entropy(local: torch.Tensor, labels: torch.Tensor, n_codebooks: int,
                  padded: int) -> torch.Tensor:
    """The mean next-token cross entropy of vocab-sharded logits (the
    reference's ``cross_entropy`` on logits pinned vocab-sharded by
    ``maybe_constrain_logits``): per (position, codebook) the max, the sum
    of exponentials and the gold logit (an index-compare mask over the
    rank's columns) are reduced over "model"; no rank holds the logits
    whole."""
    import torch.distributed as dist

    ctx = current()
    K = max(1, n_codebooks)
    labels = labels.long() if n_codebooks else labels.long()[..., None]
    x = local.float()
    c = x.shape[-1]
    c0 = ctx.coords["model"] * c
    segments = {}  # codebook -> (first local column, end, first vocab index)
    for k in range(K):
        lo, hi = max(c0, k * padded), min(c0 + c, (k + 1) * padded)
        if lo < hi:
            segments[k] = (lo - c0, hi - c0, lo - k * padded)
    lead = x.shape[:-1]
    with torch.no_grad():
        mx = torch.full((*lead, K), -math.inf, dtype=torch.float32, device=x.device)
        for k, (a, b, _) in segments.items():
            mx[..., k] = x[..., a:b].amax(dim=-1)
        _all_reduce_(mx, ctx.group("model"), dist.ReduceOp.MAX)
    zero = torch.zeros(lead, dtype=torch.float32, device=x.device)
    sums, golds = [], []
    for k in range(K):
        if k not in segments:
            sums.append(zero)
            golds.append(zero)
            continue
        a, b, v0 = segments[k]
        seg = x[..., a:b]
        sums.append(torch.sum(torch.exp(seg - mx[..., k:k + 1]), dim=-1))
        slot = torch.arange(v0, v0 + (b - a), device=x.device)
        onehot = labels[..., k:k + 1] == slot
        golds.append(torch.sum(torch.where(onehot, seg, 0.0), dim=-1))
    s = reduce_from_model(torch.stack(sums, dim=-1))
    gold = reduce_from_model(torch.stack(golds, dim=-1))
    lse = torch.log(s) + mx
    return torch.mean(lse - gold)
