"""Shared helpers of the port's parity tests (imported, not collected).

Each helper reads a result of either package by attribute, so the same
call takes a reference object and its port twin; the tests compare the
two outputs with ``==``. Timing fields (``wall_time_s``,
``planner_time_s``, ``build_time_s``, ``solve_time_s``,
``solver_wall_s``) are left out everywhere."""

from __future__ import annotations

from dataclasses import asdict, fields

import numpy as np

from repro_torch import convert
from repro_torch.core.surface import ProtocolSurface

SURFACE_ARRAYS = ("splits", "chunk_bytes", "latency_s", "runner_splits",
                  "runner_latency_s", "variant")


def _plain(x):
    """Numpy arrays as (dtype, shape, bytes) so ``==`` compares every bit
    (NaN-free here: +inf compares equal to itself)."""
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tolist())
    return x


def solver_fields(res) -> dict:
    """A scalar ``SolverResult`` without its wall time."""
    return {k: getattr(res, k) for k in
            ("solver", "splits", "cost_s", "nodes_expanded", "variant", "feasible")}


def batched_fields(res) -> dict:
    """A ``BatchedSolverResult`` without its wall time."""
    names = ("solver", "backend", "n_devices", "splits", "cost_s", "feasible",
             "n_devices_s", "channels", "channel_cost_s", "variant")
    return {k: _plain(getattr(res, k)) for k in names}


def plan_fields(plan) -> dict:
    """Every ``SplitPlan`` field but ``planner_time_s``, read through
    ``convert.plan_from_reference`` (which also takes a port plan)."""
    p = convert.plan_from_reference(plan).to_dict()
    p.pop("planner_time_s")
    return p


def surface_fields(surface) -> dict:
    """A ``DegradationSurface`` as plain values: per protocol its axes,
    base link (as a field dict) and every array of ``ProtocolSurface``;
    plus the fleet size and the solver."""
    out = {"n_devices": surface.n_devices, "solver": surface.solver}
    for name, p in surface.protocols.items():
        base = convert.link_from_reference(p.base)
        out[name] = {
            "protocol": p.protocol,
            "base": {f.name: getattr(base, f.name) for f in fields(base)},
            "packet_time_s": tuple(p.packet_time_s),
            "loss_p": tuple(p.loss_p),
            **{k: _plain(getattr(p, k)) for k in SURFACE_ARRAYS},
        }
    return out


def surface_field_names() -> set[str]:
    """The ``ProtocolSurface`` fields :func:`surface_fields` must cover."""
    return {f.name for f in fields(ProtocolSurface)}


def family_fields(family: dict) -> dict:
    return {n: surface_fields(s) for n, s in family.items()}


def row_fields(row) -> dict:
    """A ``SweepRow`` without its wall share."""
    d = row.to_dict()
    d.pop("solver_wall_s")
    return d


def decisions(history) -> list[dict]:
    """An adaptive manager's ``PlanDecision`` history as plain dicts."""
    return [asdict(d) for d in history]


def protocols(ref_protocols: dict, port: bool) -> dict:
    """A ``{name: LinkProfile}`` map, converted for the port."""
    if not port:
        return dict(ref_protocols)
    return {k: convert.link_from_reference(v) for k, v in ref_protocols.items()}
