"""Carry the reference's planning state across to the port.

The reference's "weights" are its cost profiles, links, devices,
bottleneck variants and scenario grids. These functions rebuild each as
the port's own dataclass, reading the reference object by attribute as
plain numbers, strings and tuples: ``repro`` is never imported, so any
object with the same fields converts."""

from __future__ import annotations

from dataclasses import fields

from repro_torch.core.latency import (
    BottleneckVariant,
    DeviceProfile,
    LayerCost,
    LinkProfile,
    ModelCostProfile,
)
from repro_torch.core.sweep import ScenarioGrid

__all__ = [
    "device_from_reference",
    "grid_from_reference",
    "link_from_reference",
    "profile_from_reference",
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
