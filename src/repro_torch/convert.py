"""Carry the reference's state across to the port.

The planner's "weights" are its cost profiles, links, devices,
bottleneck variants, scenario grids and split plans. These functions
rebuild each as the port's own dataclass, reading the reference object by
attribute as plain numbers, strings and tuples: ``repro`` is never
imported, so any object with the same fields converts. The LM's weights
arrive as the reference's parameter pytree of numpy arrays and leave as
the port's state dict (:func:`lm_params_from_reference`). Int8 tensors
and quantized parameter trees leave as the port's ``QTensor``s
(:func:`qtensor_from_reference`, :func:`quantized_params_from_reference`).
The CNNs' parameter trees leave in the port's layout
(:func:`cnn_params_from_reference`)."""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from repro_torch.core.latency import (
    BottleneckVariant,
    ContentionModel,
    DeviceProfile,
    LayerCost,
    LinkProfile,
    ModelCostProfile,
    SplitCostModel,
)
from repro_torch.core.planner import SegmentPlan, SplitPlan
from repro_torch.core.quantization import QTensor
from repro_torch.core.sweep import ScenarioGrid
from repro_torch.models.cnn_common import conv_weight
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import is_homogeneous

__all__ = [
    "cnn_params_from_reference",
    "cost_model_from_reference",
    "device_from_reference",
    "grid_from_reference",
    "link_from_reference",
    "lm_params_from_reference",
    "plan_from_reference",
    "profile_from_reference",
    "qtensor_from_reference",
    "quantized_params_from_reference",
    "variant_from_reference",
]


def _copy_fields(cls, obj):
    """``cls`` built from the same-named attributes of ``obj``."""
    return cls(**{f.name: getattr(obj, f.name) for f in fields(cls)})


def profile_from_reference(p) -> ModelCostProfile:
    """A ``ModelCostProfile`` from the reference's, layer by layer."""
    return ModelCostProfile(
        name=p.name,
        layers=tuple(_copy_fields(LayerCost, lc) for lc in p.layers),
        input_bytes=p.input_bytes,
    )


def link_from_reference(link) -> LinkProfile:
    return _copy_fields(LinkProfile, link)


def device_from_reference(dev) -> DeviceProfile:
    return _copy_fields(DeviceProfile, dev)


def variant_from_reference(v) -> BottleneckVariant:
    return _copy_fields(BottleneckVariant, v)


def cost_model_from_reference(model) -> SplitCostModel:
    """A ``SplitCostModel`` from the reference's: its profile, devices,
    link, contention schedule and bottleneck variant converted, its
    objective and other flags copied."""
    return SplitCostModel(
        profile=profile_from_reference(model.profile),
        devices=tuple(device_from_reference(d) for d in model.devices),
        link=link_from_reference(model.link),
        objective=model.objective,
        include_setup=model.include_setup,
        contention=(None if model.contention is None
                    else _copy_fields(ContentionModel, model.contention)),
        variant=(None if model.variant is None
                 else variant_from_reference(model.variant)),
    )


def grid_from_reference(grid) -> ScenarioGrid:
    """A ``ScenarioGrid`` with every profile converted; scalar axes and
    knobs are copied as they are."""
    nested = {
        "models": {k: profile_from_reference(v) for k, v in grid.models.items()},
        "links": {k: link_from_reference(v) for k, v in grid.links.items()},
        "devices": tuple(device_from_reference(d) for d in grid.devices),
        "device_mixes": None if grid.device_mixes is None else {
            name: tuple(device_from_reference(d) for d in mix)
            for name, mix in grid.device_mixes.items()},
    }
    plain = {f.name: getattr(grid, f.name) for f in fields(ScenarioGrid)
             if f.name not in nested}
    return ScenarioGrid(**nested, **plain)


def plan_from_reference(plan) -> SplitPlan:
    """A ``SplitPlan`` (with its ``SegmentPlan``s) from the reference's."""
    plain = {f.name: getattr(plan, f.name) for f in fields(SplitPlan)
             if f.name != "segments"}
    return SplitPlan(segments=tuple(_copy_fields(SegmentPlan, s)
                                    for s in plan.segments), **plain)


def _tensor(a) -> torch.Tensor:
    """A CPU tensor of ``a``'s values and type; numpy has no bfloat16, so
    a bfloat16 array goes through float32 (exact both ways)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix: str = ""):
    """(dotted path, leaf) of a nested dict of arrays, in its order."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield prefix + key, value


def lm_params_from_reference(cfg: ModelConfig, params) -> dict[str, torch.Tensor]:
    """The port's ``Transformer`` state dict from the reference's
    ``init_params`` pytree. The port's modules keep the reference's leaf
    names (``attn.wq`` or MLA's ``attn.q_down``, the MoE's ``ff.router``
    and stacked ``ff.w_in``, a mixer block's ``norm.scale`` and
    ``mixer.in_proj`` / ``mixer.A_log`` / ``mixer.r``, ...), so a leaf
    at dotted path ``<path>`` of a per-layer stack lands at:

    * homogeneous attention stacks (``blocks`` one stack, leading axis
      ``n_layers``): ``blocks.<i>.<path>``;
    * block patterns (``blocks`` one stack per kind, leading axis that
      kind's count in ``cfg.pattern``): ``blocks.<kind>.<i>.<path>``
      (``mamba``, ``mlstm``, ``slstm``, and ``attn`` without
      ``shared_attn``); the shared block (``blocks.attn_shared``, not
      stacked) at ``blocks.attn_shared.<path>``.

    The embedding (one table per codebook, stacked) and the head come
    across as they are; a tied head has no weight. Load it with
    ``Transformer(cfg, device=...).load_state_dict(...)``."""
    sd = {"embed.table": _tensor(params["embed"]["table"]),
          "final_norm.scale": _tensor(params["final_norm"]["scale"])}
    if "w" in params["lm_head"]:
        sd["lm_head.w"] = _tensor(params["lm_head"]["w"])
    stacks = ({"": (params["blocks"], cfg.n_layers)} if is_homogeneous(cfg) else
              {f"{kind}.": (tree, None if kind == "attn_shared" else cfg.pattern.count(kind))
               for kind, tree in params["blocks"].items()})
    for prefix, (tree, n) in stacks.items():
        for path, stack in _leaves(tree):
            if n is None:
                sd[f"blocks.{prefix}{path}"] = _tensor(stack)
                continue
            stack = np.asarray(stack)
            if stack.shape[0] != n:
                raise ValueError(f"{prefix}{path}: {stack.shape[0]} layers, "
                                 f"config has {n}")
            for i in range(n):
                sd[f"blocks.{prefix}{i}.{path}"] = _tensor(stack[i])
    return sd


def qtensor_from_reference(qt) -> QTensor:
    """The port's ``QTensor`` from the reference's (values, scale,
    zero_point and axis, read as numpy arrays: the same bits)."""
    return QTensor(values=_tensor(qt.values), scale=_tensor(qt.scale),
                   zero_point=_tensor(qt.zero_point), axis=qt.axis)


def quantized_params_from_reference(tree):
    """A ``quantize_params`` tree of the reference (nested dicts, lists
    and tuples) with each ``QTensor`` converted and each array leaf a CPU
    tensor of the same values; any other leaf is kept as it is."""
    if isinstance(tree, dict):
        return {k: quantized_params_from_reference(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(quantized_params_from_reference(v) for v in tree)
    if all(hasattr(tree, f) for f in ("values", "scale", "zero_point", "axis")):
        return qtensor_from_reference(tree)
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return _tensor(tree)
    return tree


def cnn_params_from_reference(params):
    """The port's parameter tree of ``MobileNetV2`` / ``ResNet50`` from
    the reference's ``init`` tree (nested dicts of arrays, read as numpy),
    as CPU tensors: every 4-D conv kernel ``w`` from HWIO to the port's
    layout (:func:`repro_torch.models.cnn_common.conv_weight`), every
    other leaf (scales, biases, dense ``w`` and ``b``) as it is."""
    if isinstance(params, dict):
        return {k: (conv_weight(_tensor(v)) if k == "w" and np.ndim(v) == 4
                    else cnn_params_from_reference(v))
                for k, v in params.items()}
    return _tensor(params)
