"""Split-point planner: cost model -> solved split plan.

The port's counterpart of ``repro.core.planner``, line for line:

* :func:`plan_split` — the paper's IoT scenario: an L-layer model, N
  devices, one wireless protocol; minimizes Eq. 8 with any scalar solver
  of :data:`repro_torch.core.solvers.SOLVERS` or a batched engine of
  :data:`repro_torch.core.sweep.BATCHED_SOLVERS`.
* :func:`plan_split_batch` — many cost models in one batched pass; its
  exact DP runs on the dense CUDA kernel by default.
* :func:`compare_solvers` (Figs. 3-4), :func:`plan_surface`,
  :func:`plans_from_batched` and :func:`uniform_split`.

The reference's ``plan_split_batch`` is a shim over its planner tier
(``repro.core.spec.PlannerService``), which the port does not have yet:
here it calls :func:`_plan_split_batch_impl` directly. The TPU pipeline
planner (``tpu_cost_profile``, ``plan_pipeline``) is not ported: it
needs stage profiles of the card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import solvers as S
from repro_torch.core import sweep as SW  # no cycle: sweep depends only on latency/solvers
from repro_torch.core.latency import (
    BottleneckVariant,
    LinkProfile,
    SplitCostModel,
)


@dataclass(frozen=True)
class SegmentPlan:
    device: int  # 1-indexed device/stage
    first_layer: int  # 1-indexed inclusive
    last_layer: int
    layer_names: tuple[str, ...]
    infer_s: float
    param_bytes: int
    tx_bytes: int  # activation bytes leaving this segment (0 for the last)
    cost_s: float


@dataclass(frozen=True)
class SplitPlan:
    model: str
    solver: str
    n_devices: int
    splits: tuple[int, ...]
    segments: tuple[SegmentPlan, ...]
    total_latency_s: float  # Eq. 8 incl. setup + feedback
    objective_cost_s: float  # solver objective (no overheads)
    planner_time_s: float
    nodes_expanded: int
    # joint (split, variant) solves report the adopted bottleneck
    # variant: its bank index and accuracy proxy. None / 1.0 for plain
    # single-variant plans (the historical shape).
    variant: int | None = None
    accuracy_proxy: float = 1.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _build_plan(
    model: SplitCostModel, result: S.SolverResult, n_devices: int
) -> SplitPlan:
    prof = model.profile
    L = prof.num_layers
    bounds = [0, *result.splits, L]
    segments = []
    for i in range(len(bounds) - 1):
        a, b = bounds[i] + 1, bounds[i + 1]
        segments.append(
            SegmentPlan(
                device=i + 1,
                first_layer=a,
                last_layer=b,
                layer_names=tuple(lc.name for lc in prof.layers[a - 1 : b]),
                infer_s=prof.segment_infer_s(a, b),
                param_bytes=prof.segment_param_bytes(a, b),
                # bytes that actually cross the cut: the model's variant
                # (if any) compresses the boundary activation, and the
                # runtime prices hops from exactly this field
                tx_bytes=model.cut_payload_bytes(b) if b < L else 0,
                cost_s=model.segment_cost_s(a, b, i + 1),
            )
        )
    total = model.end_to_end_s(result.splits, with_overheads=True) if result.feasible else float("inf")
    v = model._active_variant
    return SplitPlan(
        model=prof.name,
        solver=result.solver,
        n_devices=n_devices,
        splits=result.splits,
        segments=tuple(segments),
        total_latency_s=total,
        objective_cost_s=result.cost_s,
        planner_time_s=result.wall_time_s,
        nodes_expanded=result.nodes_expanded,
        variant=result.variant,
        accuracy_proxy=1.0 if v is None else v.accuracy_proxy,
    )


def plan_split(
    cost_model: SplitCostModel,
    n_devices: int,
    solver: str = "beam",
    energy_budget: float | None = None,
    variants: Sequence[BottleneckVariant] | None = None,
    accuracy_floor: float | None = None,
    **solver_kwargs,
) -> SplitPlan:
    """Solve Eq. 9 for the given cost model and device count.

    ``solver`` accepts the scalar algorithms in
    :data:`repro_torch.core.solvers.SOLVERS` plus the vectorized engines
    (``"batched_dp"``, ``"batched_beam"``, ``"batched_greedy"``) which
    run on the dense cost tensor in one array pass instead of a Python
    segment loop. ``batched_dp``/``batched_greedy`` are bit-identical
    to their scalar oracles; ``batched_beam`` is bit-identical except
    on exact floating-point cost ties (see its docstring).

    ``energy_budget`` caps every device's segment energy in Joules:
    scalar solvers see over-budget segments as +inf via
    :func:`repro_torch.core.solvers.budget_masked` (the model's own
    :meth:`SplitCostModel.segment_energy_j` prices them); batched
    solvers mask the stacked tensor the same way
    (:func:`repro_torch.core.sweep.apply_energy_budget`).

    ``variants``: optional bottleneck-variant bank (see
    :func:`repro_torch.core.profiles.esp32_variant_bank`). The solve then
    jointly optimizes (split point, variant) — scalar solvers via their
    ``variants=`` dispatch, batched solvers via
    :func:`repro_torch.core.sweep.solve_variant_bank` — and the returned
    plan's ``variant`` / ``accuracy_proxy`` report the adopted variant,
    with every ``tx_bytes`` priced at its compressed payload.
    ``accuracy_floor`` (requires ``variants``) masks variants whose
    ``accuracy_proxy`` falls below the floor: ``min latency s.t.
    accuracy_proxy >= floor``."""
    L = cost_model.profile.num_layers
    if not 1 <= n_devices <= L:
        raise ValueError(f"n_devices={n_devices} out of range for L={L}")
    if accuracy_floor is not None and variants is None:
        raise ValueError("accuracy_floor requires a variants bank")
    if solver in SW.BATCHED_SOLVERS:
        return plan_split_batch([cost_model], n_devices, solver=solver,
                                energy_budget=energy_budget,
                                variants=variants,
                                accuracy_floor=accuracy_floor,
                                **solver_kwargs)[0]
    fn = S.SOLVERS[solver]
    combine = "max" if cost_model.objective == "bottleneck" else "sum"
    if variants is not None:
        bank_models = [dataclasses.replace(cost_model, variant=v)
                       for v in variants]
        insts = [
            S.VariantInstance(
                cost_fn=m.cost_segment_fn(),
                energy_fn=(m.energy_segment_fn()
                           if energy_budget is not None else None),
                accuracy_proxy=v.accuracy_proxy,
            )
            for m, v in zip(bank_models, variants)
        ]
        result = fn(None, L, n_devices, combine=combine,
                    energy_budget=energy_budget, variants=insts,
                    accuracy_floor=accuracy_floor, **solver_kwargs)
        chosen = (cost_model if result.variant is None
                  else bank_models[result.variant])
        return _build_plan(chosen, result, n_devices)
    if energy_budget is not None:
        solver_kwargs = dict(solver_kwargs,
                             energy_fn=cost_model.energy_segment_fn(),
                             energy_budget=energy_budget)
    result = fn(
        cost_model.cost_segment_fn(),
        L,
        n_devices,
        combine=combine,
        **solver_kwargs,
    )
    return _build_plan(cost_model, result, n_devices)


def plan_split_batch(
    cost_models: Sequence[SplitCostModel],
    n_devices: int | Sequence[int],
    solver: str = "batched_dp",
    backend: str | None = None,
    energy_budget: float | Sequence[float] | None = None,
    variants: Sequence[BottleneckVariant] | None = None,
    accuracy_floor: float | None = None,
    mesh_spec=None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
    **solver_kwargs,
) -> list[SplitPlan]:
    """Plan many cost models in one batched pass (see
    :func:`_plan_split_batch_impl`). In the reference a shim over the
    planner tier; the port has none yet, so this calls the impl directly,
    after the normalisation the reference's spec builder applies to
    ``n_devices`` (a numpy integer becomes an ``int``, a sequence a
    tuple of ``int``: the same values)."""
    if isinstance(n_devices, (int, np.integer)):
        n_devices = int(n_devices)
    elif n_devices is not None:
        n_devices = tuple(int(v) for v in np.asarray(n_devices).reshape(-1))
    return _plan_split_batch_impl(
        cost_models, n_devices, solver=solver, backend=backend,
        energy_budget=energy_budget, variants=variants,
        accuracy_floor=accuracy_floor, mesh_spec=mesh_spec, device=device,
        dtype=dtype, **solver_kwargs)


def _plan_split_batch_impl(
    cost_models: Sequence[SplitCostModel],
    n_devices: int | Sequence[int],
    solver: str = "batched_dp",
    backend: str | None = None,
    energy_budget: float | Sequence[float] | None = None,
    variants: Sequence[BottleneckVariant] | None = None,
    accuracy_floor: float | None = None,
    mesh_spec=None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
    **solver_kwargs,
) -> list[SplitPlan]:
    """Plan many scenarios in one batched pass over stacked cost tensors.

    All ``cost_models`` must share a layer count (same model graph;
    links/devices/objectives may differ per scenario — the fleet
    what-if case, including heterogeneous device mixes: each cost
    model carries its own device tuple into its tensor slice).
    ``n_devices`` may be a single fleet size or one per cost model
    (heterogeneous fleet sizes batch in the same pass; the tensor is
    stacked at the largest size and each scenario reads its own
    prefix). Returns one :class:`SplitPlan` per input, in order. The
    amortization is the point: S scenarios cost one tensor solve
    instead of S Python-loop DP runs (see ``benchmarks/sweep_grid.py``).

    ``backend``: ``None`` (``"cuda"`` for ``solver="batched_dp"``: the
    dense CUDA kernel; ``"numpy"`` for beam and greedy, which run on the
    host and take no other backend), or a
    :data:`repro_torch.core.sweep.DP_BACKENDS` key for ``batched_dp``:
    ``"cuda"``, ``"torch"`` (its plain PyTorch version) or ``"numpy"``
    (the float64 oracle). ``device`` / ``dtype`` reach the ``"cuda"`` and
    ``"torch"`` backends (``device=None`` is the card).

    ``energy_budget``: optional per-device Joule cap — a scalar for all
    scenarios or one per cost model. Segments whose energy (each
    model's own :meth:`SplitCostModel.energy_cost_tensor`) exceeds the
    budget are masked to +inf before the solve
    (:func:`repro_torch.core.sweep.apply_energy_budget`), so plans minimize
    latency subject to the budget on every backend.

    ``variants`` / ``accuracy_floor``: joint (split, variant) solves —
    the stacked tensor grows a variant axis and
    :func:`repro_torch.core.sweep.solve_variant_bank` folds it into the
    scenario batch; see :func:`plan_split`."""
    if not cost_models:
        return []
    if accuracy_floor is not None and variants is None:
        raise ValueError("accuracy_floor requires a variants bank")
    L = cost_models[0].profile.num_layers
    if isinstance(n_devices, int):
        n_list = [n_devices] * len(cost_models)
    else:
        n_list = [int(n) for n in n_devices]
        if len(n_list) != len(cost_models):
            raise ValueError(
                f"n_devices has {len(n_list)} entries for "
                f"{len(cost_models)} cost models")
    for n in n_list:
        if not 1 <= n <= L:  # same contract as plan_split
            raise ValueError(f"n_devices={n} out of range for L={L}")
    objectives = {m.objective for m in cost_models}
    if len(objectives) != 1:
        raise ValueError(f"cost_models mix objectives {sorted(objectives)}")
    combine = "max" if cost_models[0].objective == "bottleneck" else "sum"
    # per-model export sizes: each cost model's device tuple only has to
    # cover its OWN fleet (smaller fleets get +inf-padded device slices
    # the solvers never read)
    n_arg = n_devices if isinstance(n_devices, int) else n_list
    ns = None if isinstance(n_devices, int) else np.asarray(n_list, np.int64)
    if variants is not None:
        C = SW.stack_cost_tensors(cost_models, n_arg, variants=variants)
        if energy_budget is not None:
            # one energy tensor per variant slice (encoder Joules differ),
            # each masked exactly like the single-variant path
            C = np.stack([
                SW.apply_energy_budget(
                    C[vi],
                    SW.stack_cost_tensors(
                        [dataclasses.replace(m, variant=v)
                         for m in cost_models],
                        n_arg, channels=("energy",))[0],
                    energy_budget)
                for vi, v in enumerate(variants)
            ])
        res = SW.solve_variant_bank(
            C, solver=solver, combine=combine, backend=backend, n_devices=ns,
            accuracy_proxy=[v.accuracy_proxy for v in variants],
            accuracy_floor=accuracy_floor, mesh_spec=mesh_spec,
            device=device, dtype=dtype, **solver_kwargs)
        return plans_from_batched(cost_models, res, n_list,
                                  nodes_expanded=int(np.prod(C.shape[2:])),
                                  variants=variants)
    C = SW.stack_cost_tensors(cost_models, n_arg)
    if energy_budget is not None:
        E = SW.stack_cost_tensors(cost_models, n_arg, channels=("energy",))[0]
        C = SW.apply_energy_budget(C, E, energy_budget)
    res = SW.solve_batched(C, solver=solver, combine=combine, backend=backend,
                           n_devices=ns, mesh_spec=mesh_spec, device=device,
                           dtype=dtype, **solver_kwargs)
    return plans_from_batched(cost_models, res, n_list,
                              nodes_expanded=int(np.prod(C.shape[1:])))


def plans_from_batched(
    cost_models: Sequence[SplitCostModel],
    res,  # sweep.BatchedSolverResult
    n_devices: int | Sequence[int],
    nodes_expanded: int = 0,
    variants: Sequence[BottleneckVariant] | None = None,
) -> list[SplitPlan]:
    """Materialize per-scenario :class:`SplitPlan`\\ s from one batched
    solver result (shared by the planner and the adaptive manager).
    ``n_devices``: one fleet size for all scenarios, or one per
    scenario. When the result came from a variant-bank solve
    (``res.variant`` set) pass the same ``variants`` bank: each plan is
    then built on its winning variant's cost model, so segment costs
    and ``tx_bytes`` price the compressed cut."""
    if isinstance(n_devices, int):
        n_list = [n_devices] * len(cost_models)
    else:
        n_list = [int(n) for n in n_devices]
    wall = res.wall_time_s / max(1, len(cost_models))
    plans = []
    for i, m in enumerate(cost_models):
        vi = None
        if res.variant is not None:
            vi = int(res.variant[i])
            if vi >= 0 and variants is not None:
                m = dataclasses.replace(m, variant=variants[vi])
        sr = S.SolverResult(
            solver=res.solver,
            splits=res.splits_tuple(i),
            cost_s=float(res.cost_s[i]),
            wall_time_s=wall,
            nodes_expanded=nodes_expanded,
            variant=None if vi is None or vi < 0 else vi,
        )
        plans.append(_build_plan(m, sr, n_list[i]))
    return plans


def plan_surface(
    cost_model: SplitCostModel,
    protocols: "dict[str, LinkProfile]",
    n_devices: int,
    **kwargs,
):
    """Precompute a :class:`~repro_torch.core.surface.DegradationSurface`: the
    best plan, tuned chunk, and latency for every (protocol ×
    packet-time × loss) link condition, solved in one batched
    sweep-engine pass. The adaptive manager consumes it for O(1)
    ``observe()`` replanning; see :mod:`repro_torch.core.surface`."""
    from repro_torch.core.surface import build_surface  # lazy: keeps import light

    return build_surface(cost_model, protocols, n_devices, **kwargs)


def compare_solvers(
    cost_model: SplitCostModel,
    n_devices: int,
    solvers: Sequence[str] = ("beam", "greedy", "first_fit", "random_fit", "brute_force"),
    **per_solver_kwargs,
) -> dict[str, SplitPlan]:
    """Run several solvers on the same instance (Figs. 3-4)."""
    out = {}
    for name in solvers:
        kwargs = per_solver_kwargs.get(name, {}) if per_solver_kwargs else {}
        out[name] = plan_split(cost_model, n_devices, solver=name, **kwargs)
    return out


def uniform_split(L: int, n_devices: int) -> tuple[int, ...]:
    """Equal-layer-count baseline split (what a naive PP config does)."""
    return tuple(round(L * i / n_devices) for i in range(1, n_devices))
