"""Carry the reference's state across to the port.

The planner's "weights" are its cost profiles, links, devices,
bottleneck variants, scenario grids and split plans. These functions
rebuild each as the port's own dataclass, reading the reference object by
attribute as plain numbers, strings and tuples: ``repro`` is never
imported, so any object with the same fields converts. The LM's weights
arrive as the reference's parameter pytree of numpy arrays and leave as
the port's state dict (:func:`lm_params_from_reference`). Int8 tensors
and quantized parameter trees leave as the port's ``QTensor``s
(:func:`qtensor_from_reference`, :func:`quantized_params_from_reference`)."""

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
from repro_torch.models.config import ModelConfig

__all__ = [
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


# port name -> path in the reference's block pytree
_BLOCK_LEAVES = {
    "norm1.scale": ("norm1", "scale"),
    "attn.wq": ("attn", "wq"),
    "attn.wk": ("attn", "wk"),
    "attn.wv": ("attn", "wv"),
    "attn.wo": ("attn", "wo"),
    "norm2.scale": ("norm2", "scale"),
    "ff.w_in": ("ff", "w_in"),
    "ff.w_out": ("ff", "w_out"),
    "ff.w_gate": ("ff", "w_gate"),
}


def lm_params_from_reference(cfg: ModelConfig, params) -> dict[str, torch.Tensor]:
    """The port's ``Transformer`` state dict from the reference's
    ``init_params`` pytree of a homogeneous dense config: its per-layer
    stacks (leading axis ``n_layers``) become ``blocks.<i>.*``. Load it
    with ``Transformer(cfg, device=...).load_state_dict(...)``."""
    blocks = params["blocks"]
    sd = {"embed.table": _tensor(params["embed"]["table"]),
          "final_norm.scale": _tensor(params["final_norm"]["scale"]),
          "lm_head.w": _tensor(params["lm_head"]["w"])}
    for name, (group, leaf) in _BLOCK_LEAVES.items():
        if leaf not in blocks[group]:
            continue  # w_gate of a non-gated MLP
        stack = np.asarray(blocks[group][leaf])
        if stack.shape[0] != cfg.n_layers:
            raise ValueError(f"{group}.{leaf}: {stack.shape[0]} layers, "
                             f"config has {cfg.n_layers}")
        for i in range(cfg.n_layers):
            sd[f"blocks.{i}.{name}"] = _tensor(stack[i])
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
