"""Split-plan executor: run a partitioned model segment by segment.

The port's copy of the reference's ``core/executor.py``. It takes split
points (a :class:`~repro_torch.core.planner.SplitPlan`'s ``splits``) and a
*sequential layer-list model* and executes each segment as if on its own
device, simulating the device hop at every boundary:

  1. run layers [s_{i-1}+1 .. s_i] on "device" i,
  2. quantize the boundary activation to the int8 wire format,
  3. account packets / expected transmission time on the link profile,
  4. dequantize on "device" i+1 and continue.

With ``quantize_wire=False`` a hop hands on the very tensors it got (no
copy, no change of memory format), so split execution is bit-identical
to the unsplit forward pass for any split configuration. Everything runs
on the device of the input and the parameters.

A sequential layer-list model is any object with:
  * ``layer_names`` — ordered list of L layer names,
  * ``init(generator, device)`` — params dict keyed by layer name,
  * ``apply_layer(name, params, x)`` — apply one layer.
CNNs with residual blocks carry the skip beside the main tensor in a
dict, so the chain is truly sequential (the paper's Eq. 1 view).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Protocol, Sequence

import torch

from repro_torch.core.latency import LinkProfile
from repro_torch.core.quantization import decode_activation, encode_activation

__all__ = ["ExecutionTrace", "HopRecord", "SequentialModel", "run_split",
           "run_unsplit", "segment_bounds"]


class SequentialModel(Protocol):
    layer_names: Sequence[str]

    def init(self, generator: torch.Generator | None = None, device=None) -> dict: ...

    def apply_layer(self, name: str, params: Any, x: Any) -> Any: ...


@dataclass
class HopRecord:
    boundary_layer: str
    nbytes: int
    n_packets: int
    sim_latency_s: float


@dataclass
class ExecutionTrace:
    hops: list[HopRecord] = field(default_factory=list)

    @property
    def total_tx_bytes(self) -> int:
        return sum(h.nbytes for h in self.hops)

    @property
    def total_tx_latency_s(self) -> float:
        return sum(h.sim_latency_s for h in self.hops)


def segment_bounds(splits: Sequence[int], num_layers: int) -> list[tuple[int, int]]:
    """[(first, last)] 1-indexed inclusive segments from split points."""
    bounds = [0, *splits, num_layers]
    out = []
    for i in range(len(bounds) - 1):
        if not bounds[i] < bounds[i + 1]:
            raise ValueError(f"invalid splits {splits} for L={num_layers}")
        out.append((bounds[i] + 1, bounds[i + 1]))
    return out


def _map_leaves(fn, carry):
    """``fn`` on every tensor of a carry (a tensor, or nested dicts of
    them), dict keys visited in sorted order as ``jax.tree.flatten``
    visits them."""
    if isinstance(carry, dict):
        return {k: _map_leaves(fn, carry[k]) for k in sorted(carry)}
    return fn(carry)


def _wire_encode(carry):
    """Ship the live carry across a device hop: int8-quantize every float
    leaf (the TinyML wire format), return (decoded carry, wire bytes).
    The bytes are the int8 payloads only."""
    nbytes = 0

    def ship(leaf):
        nonlocal nbytes
        qt = encode_activation(leaf)
        nbytes += qt.nbytes
        return decode_activation(qt, dtype=leaf.dtype)

    with torch.profiler.record_function("wire_encode"):
        return _map_leaves(ship, carry), nbytes


def _carry_bytes(carry) -> int:
    total = 0

    def count(leaf):
        nonlocal total
        total += leaf.numel() * leaf.element_size()

    _map_leaves(count, carry)
    return total


def run_split(
    model: SequentialModel,
    params: dict,
    x,
    splits: Sequence[int],
    *,
    link: LinkProfile | None = None,
    quantize_wire: bool = False,
):
    """Execute the model partitioned at ``splits``, simulating device hops.

    The carry ``x`` may be a tensor or a dict of them (CNN blocks carry
    the residual skip alongside the main tensor). ``quantize_wire=True``
    ships int8 activations (the deployed TinyML wire format); ``False``
    ships the float tensors as they are (the exactness property). Returns
    ``(final_carry, ExecutionTrace)``."""
    names = list(model.layer_names)
    trace = ExecutionTrace()
    for a, b in segment_bounds(splits, len(names)):
        for li in range(a, b + 1):
            name = names[li - 1]
            x = model.apply_layer(name, params[name], x)
        is_last = b == len(names)
        if not is_last:
            if quantize_wire:
                x, nbytes = _wire_encode(x)
            else:
                nbytes = _carry_bytes(x)
            if link is not None:
                trace.hops.append(
                    HopRecord(
                        boundary_layer=names[b - 1],
                        nbytes=nbytes,
                        n_packets=link.packets(nbytes),
                        sim_latency_s=link.transmission_latency_s(nbytes),
                    )
                )
            else:
                trace.hops.append(HopRecord(names[b - 1], nbytes, 0, 0.0))
    return x, trace


def run_unsplit(model: SequentialModel, params: dict, x):
    """Reference forward pass (no partitioning)."""
    for name in model.layer_names:
        x = model.apply_layer(name, params[name], x)
    return x
