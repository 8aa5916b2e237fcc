"""Sharding rules: parameter, batch and cache specs for the production mesh.

The port's counterpart of ``repro.parallel.sharding``, rule for rule.

Axes:
  * ``data`` (+ ``pod`` when multi-pod) — batch / data parallelism,
  * ``model`` — tensor parallelism: attention heads, FFN hidden, experts
    (EP), vocab.

Rules are name-based and divisibility-checked: a dim is sharded only when
its size divides the mesh axis size, otherwise the rule falls through to
the next candidate dim (e.g. minicpm3's 40 heads don't divide a 16-wide
model axis — its attention shards on the fused head*dim axis instead; MQA
kv projections replicate). Leading layer-stack dims are never sharded.

Long-context (batch=1) cells shard the KV-cache *sequence* dim over
``data`` instead of batch.

Each rule is a pure function of (path, shape, mesh shape). A spec is a
tuple with one entry per dim: an axis name, a tuple of axis names such
as ``("pod", "data")``, or ``None``. A mesh is a ``{axis: size}`` mapping
or a ``torch.distributed`` ``DeviceMesh`` (its ``mesh_dim_names`` and
shape give the same mapping), so no rule needs a process group.
:class:`NamedSharding` pairs a mesh with a spec, as JAX's does, and
:func:`to_placements` turns a spec into DTensor placements on a
``DeviceMesh``: ``Shard(d)`` on each mesh dim that an axis of dim ``d``
names, ``Replicate()`` elsewhere. :func:`distribute` applies them.

The port keeps one module per layer (``blocks.<i>.<path>``) where the
reference stacks a layer axis (``blocks/<path>`` of shape (L, ...)), and
a leaf's rank decides its rule (the expert rules fire on rank >= 4 only).
So :func:`params_sharding` computes each port leaf's spec on the
reference's path and stacked shape, the layer count read off the names,
and drops the layer dim, which no rule shards. The mapping is
``convert.lm_params_from_reference``'s:

* ``blocks.<i>.<path>`` <-> ``blocks/<path>`` with leading dim ``n_layers``;
* ``blocks.<kind>.<i>.<path>`` <-> ``blocks/<kind>/<path>``;
* ``blocks.attn_shared.<path>`` <-> ``blocks/attn_shared/<path>``, not stacked;
* every other leaf by its path, ``.`` for ``/``.

XLA partitions the reference's compute from these specs (SPMD). The
port's steps (``launch.steps.build_cell``) store every weight, moment,
input and cache entry by them and run the reference's tensor-parallel
plan on the local shards (:mod:`repro_torch.parallel.tensor_parallel`):
heads, FFN hidden, experts and vocab over 'model' where the axis divides
them, a sequence-split decode cache read where it is stored, every other
leaf gathered for its own layer's call only.
"""

from __future__ import annotations

import math
import re
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["NamedSharding", "batch_sharding", "cache_sharding", "distribute", "dp_axes",
           "input_sharding", "mesh_shape", "param_spec", "params_sharding", "reference_leaf",
           "replicated", "stack_depths", "to_placements", "tree_map", "tree_map_with_path"]

# (regex on the param path, candidate shard dims counted from the END of
# the shape, e.g. -1 = last dim). The first divisible candidate wins.
_PARAM_RULES: list[tuple[str, list[int]]] = [
    # embed table shards d_model (NOT vocab): token gathers and their
    # backward scatter-adds stay shard-local; the lm_head is the one that
    # shards vocab (where the big logits live).
    (r"embed/table$", [-1]),
    (r"lm_head/w$", [-1]),  # vocab(-heads)-parallel
    (r"attn/w[qkv]$", [-2, -1]),  # heads, else head_dim
    (r"attn/wo$", [-2]),  # fused head*dim (row-parallel)
    (r"attn/q_down$", [-1]),
    (r"attn/q_up$", [-2, -3]),  # heads, else lora rank (row-parallel)
    (r"attn/kv_down$", []),  # latent bottleneck: replicate
    (r"attn/kv_up_[kv]$", [-2, -3]),
    (r"ff/w_(in|gate)$", [-1]),  # MoE (E,d,f) -> experts; dense (d,f) -> f
    (r"ff/w_out$", [-2]),
    (r"ff/router$", []),
    (r"mixer/in_proj$", [-1]),
    (r"mixer/out_proj$", [-2]),
    (r"mixer/conv_[wb]$", []),
    (r"mixer/(A_log|D|dt_bias|f_bias)$", []),
    (r"mixer/r$", []),
    (r"norm", []),
    (r"scale$", []),
]

# MoE expert stacks: shard the expert dim (EP) in preference to f.
# These fire ONLY on rank-4 leaves (layer-stacked (L, E, d, f)): a
# layer-stacked DENSE weight is also rank 3, and letting the expert rule
# shard its dim -3 would shard the LAYER axis over 'model'.
_MOE_RULES: list[tuple[str, list[int]]] = [
    (r"ff/w_(in|gate)$", [-3, -1]),
    (r"ff/w_out$", [-3, -2]),
]


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or of such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    return dict(mesh) if names is None else dict(zip(names, mesh.shape))


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the layout of one tensor."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def to_placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim in its
    order: ``Shard(d)`` where dim ``d``'s entry names that axis (alone or
    in a tuple, whose order must be the mesh's, major first), else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    owner: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"spec {spec}: axis {a!r} shards dims {owner[a]} and {d}")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in names)


def param_spec(path_s: str, shape: tuple[int, ...], model_axis: str,
               model_size: int) -> tuple:
    """The spec of one param leaf at the reference's ``path_s`` and shape."""
    rules = _MOE_RULES + _PARAM_RULES if len(shape) >= 4 else _PARAM_RULES
    for pat, dims in rules:
        if re.search(pat, path_s):
            spec = [None] * len(shape)
            for d in dims:
                if len(shape) >= -d and shape[d] % model_size == 0 and shape[d] >= model_size:
                    spec[d] = model_axis
                    break
            return tuple(spec)
    return (None,) * len(shape)


_STACKED = re.compile(r"^((?:[^.]+\.)*?)blocks\.(?:(\w+)\.)?(\d+)\.(.+)$")


def _stack_path(name: str) -> tuple[str, int | None]:
    """(the reference's path of port leaf ``name``, its layer index or
    ``None`` when the leaf is not per-layer)."""
    m = _STACKED.match(name)
    if m is None:
        return name.replace(".", "/"), None
    prefix, kind, i, rest = m.groups()
    path = (prefix.replace(".", "/") + "blocks/" + (f"{kind}/" if kind else "")
            + rest.replace(".", "/"))
    return path, int(i)


def reference_leaf(name: str, shape: tuple[int, ...], depths: Mapping[str, int]
                   ) -> tuple[str, tuple[int, ...], bool]:
    """``(reference path, reference shape, stacked)`` of the port leaf
    ``name`` of ``shape``: a per-layer leaf (``blocks.<i>.<path>``,
    ``blocks.<kind>.<i>.<path>``, under any prefix such as ``mu.``) maps
    to its stack, of depth ``depths[<its stack path>]``."""
    path, i = _stack_path(name)
    if i is None:
        return path, tuple(shape), False
    return path, (depths[path], *shape), True


def stack_depths(names) -> dict[str, int]:
    """``{reference stack path: layer count}`` read off the port's names."""
    layers: dict[str, set] = {}
    for name in names:
        path, i = _stack_path(name)
        if i is not None:
            layers.setdefault(path, set()).add(i)
    return {p: len(ix) for p, ix in layers.items()}


def tree_map_with_path(fn, tree, path: str = "", sep: str = "/"):
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists, the path
    the keys and indices joined by ``sep`` (the reference's ``_path_str``)."""
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(fn, v, f"{path}{sep}{k}" if path else str(k), sep)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, f"{path}{sep}{i}" if path else str(i), sep)
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn, tree, *others):
    """``fn(leaf, *others' leaves)`` over a tree of dicts, tuples and lists
    and the same places of ``others``."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(o[i] for o in others)) for i, v in enumerate(tree))
    return fn(tree, *others)


def _named_leaves(params) -> dict[str, torch.Tensor]:
    """``{dotted name: tensor}`` of a module's parameters or a nested
    mapping of tensors."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    out = {}
    tree_map_with_path(lambda p, t: out.__setitem__(p, t), params, sep=".")
    return out


def dp_axes(mesh) -> tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _dp(mesh) -> tuple[int, Any]:
    """(DP width, the DP spec entry: one axis, a tuple of axes, or None)."""
    shape, dp = mesh_shape(mesh), dp_axes(mesh)
    size = math.prod(shape[a] for a in dp) if dp else 1
    return size, (dp if len(dp) > 1 else (dp[0] if dp else None))


def params_sharding(params, mesh, fsdp: bool = False):
    """A :class:`NamedSharding` for every leaf of ``params``: ``{name:
    sharding}`` of a module's parameters, or a nested mapping of tensors
    (a state dict, ``adamw_init``'s ``{"mu", "nu", "step"}``) in its own
    structure, a leaf named by its keys joined with ``.``.

    ``fsdp=True`` additionally shards every (large) leaf over the DP axes
    on a second dim — FSDP/ZeRO-3 parameter sharding: a leaf of at least
    2^22 bytes counted at 4 bytes an element, its stack's size when it is
    per-layer, takes the DP axes on its largest free dim that they divide,
    never the layer dim of a rank >= 3 stack. Used for the archs whose
    model-axis-only shards exceed HBM, and for optimizer moments (ZeRO-1)
    universally."""
    model_axis = "model"
    model_size = mesh_shape(mesh)[model_axis]
    dp_size, dp_name = _dp(mesh)
    leaves = _named_leaves(params)
    depths = stack_depths(leaves)

    def leaf_spec(name: str, x: torch.Tensor) -> NamedSharding:
        path, shape, stacked = reference_leaf(name, tuple(x.shape), depths)
        spec = list(param_spec(path, shape, model_axis, model_size))
        spec += [None] * (len(shape) - len(spec))
        if fsdp and dp_name is not None and math.prod(shape) * 4 >= 2**22:
            # dim 0 of stacked-block leaves is the layer stack: skip it
            start = 1 if len(shape) >= 3 else 0
            cands = sorted(range(start, len(shape)), key=lambda d: -shape[d])
            for d in cands:
                if spec[d] is None and shape[d] % dp_size == 0 and shape[d] >= dp_size:
                    spec[d] = dp_name
                    break
        if stacked:
            if spec[0] is not None:
                raise ValueError(f"{name}: the rule shards the layer dim of {path} {shape}")
            spec = spec[1:]
        return NamedSharding(mesh, tuple(spec))

    flat = {name: leaf_spec(name, x) for name, x in leaves.items()}
    if isinstance(params, torch.nn.Module):
        return flat
    return tree_map_with_path(lambda name, _: flat[name], params, sep=".")


def batch_sharding(mesh, batch_size: int, ndim: int,
                   seq_dim: int | None = None, seq_len: int = 0) -> NamedSharding:
    """Shard dim 0 (batch) over the DP axes; if the batch does not divide
    them (e.g. batch=1 long-context), shard ``seq_dim`` over 'data'."""
    dp_size, dp_name = _dp(mesh)
    spec = [None] * ndim
    if batch_size % dp_size == 0 and batch_size >= dp_size:
        spec[0] = dp_name
    elif seq_dim is not None and seq_len % mesh_shape(mesh)["data"] == 0:
        spec[seq_dim] = "data"
    return NamedSharding(mesh, tuple(spec))


def cache_sharding(cfg: ModelConfig, cache, mesh, batch: int):
    """Shardings for a decode cache tree (``init_cache``'s structure).

    Attention k/v (or MLA latents): batch over DP if divisible, else the
    sequence dim over 'data'; head dims over 'model' when divisible, else
    the sequence over 'model' (the flash-decoding split-KV pattern).
    Recurrent states (mamba/mlstm/slstm): batch over DP if divisible; inner
    (head or channel) dim over 'model' when divisible."""
    shape_of = mesh_shape(mesh)
    model_size = shape_of["model"]
    dp_size, dp_name = _dp(mesh)
    batch_ok = batch % dp_size == 0 and batch >= dp_size
    dp_spec = dp_name if batch_ok else None

    def leaf_spec(path_s: str, x) -> NamedSharding:
        shape = tuple(x.shape)
        spec = [None] * len(shape)
        # locate the batch dim: stacked homogeneous caches are (L, B, ...);
        # heterogeneous tuples are (B, ...) per layer.
        names = path_s.split("/")
        stacked = len(shape) >= 2 and shape[0] != batch and shape[1] == batch
        b_dim = 1 if stacked else 0
        if names[-1] in ("k", "v", "k_scale", "v_scale") or "c_kv" in path_s \
                or "k_rope" in path_s:
            s_dim = b_dim + 1
            if batch_ok:
                spec[b_dim] = dp_spec
            elif shape[s_dim] % shape_of["data"] == 0:
                spec[s_dim] = "data"
            h_dim = s_dim + 1
            heads_ok = (names[-1] in ("k", "v") and len(shape) >= h_dim + 1
                        and shape[h_dim] % model_size == 0
                        and shape[h_dim] >= model_size)
            if heads_ok:
                spec[h_dim] = "model"
            elif spec[s_dim] is None and shape[s_dim] % model_size == 0:
                spec[s_dim] = "model"
        else:
            # recurrent state (B, nh, ...) / (B, K-1, C) / (B, di)
            if batch_ok:
                spec[b_dim] = dp_spec
            for d in range(b_dim + 1, len(shape)):
                if shape[d] % model_size == 0 and shape[d] >= model_size:
                    spec[d] = "model"
                    break
        return NamedSharding(mesh, tuple(spec))

    return tree_map_with_path(leaf_spec, cache)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def input_sharding(cfg: ModelConfig, mesh, inputs: dict) -> dict:
    """Shardings for a model-input dict of tensors (``meta`` stand-ins or
    values): the microbatched training layout (leading N dim replicated,
    per-microbatch batch dim over DP) and each frontend's trailing dims."""
    dp_size, dp_name = _dp(mesh)

    def batch_dim_of(k, v) -> int:
        if k == "positions":
            return v.ndim - 2  # (..., 3, B, S) -> B
        if k == "embeds" or (cfg.frontend == "audio_codes" and k in ("codes", "labels")):
            return v.ndim - 3  # (..., B, S, D|K)
        return v.ndim - 2  # tokens/labels: (..., B, S)

    out = {}
    for k, v in inputs.items():
        if not hasattr(v, "shape") or v.ndim == 0:
            out[k] = replicated(mesh)
            continue
        spec = [None] * v.ndim
        bd = max(0, batch_dim_of(k, v))
        if dp_name is not None and v.shape[bd] % dp_size == 0 and v.shape[bd] >= dp_size:
            spec[bd] = dp_name
        out[k] = NamedSharding(mesh, tuple(spec))
    return out


def distribute(tree, shardings):
    """Each tensor of ``tree`` as a DTensor laid out by the matching
    :class:`NamedSharding` of ``shardings`` (the same structure; a
    ``replicated`` leaf's empty spec pads with ``None``). Every rank holds
    the same full tensor and keeps its own shard: no data moves between
    ranks. A sharded leaf's shard is a copy, also on a mesh of one rank; a
    replicated leaf's local tensor is the tensor itself."""
    from torch.distributed.tensor import distribute_tensor

    def one(t: torch.Tensor, s: NamedSharding):
        spec = tuple(s.spec) + (None,) * (t.dim() - len(s.spec))
        return distribute_tensor(t, s.mesh, to_placements(spec, s.mesh), src_data_rank=None)

    return tree_map(one, tree, shardings)
