"""Fleet-scale scenario sweeps on the card: the exact split DP, batched.

The port's counterpart of the batched-DP part of ``repro.core.sweep``:

* :func:`batched_optimal_dp` — the exact O(L² N) split DP over a stacked
  scenario axis, on one of :data:`DP_BACKENDS`: ``"cuda"`` (the dense
  CUDA kernel, :mod:`repro_torch.core.cuda_dp`), ``"torch"`` (its plain
  PyTorch version, the counterpart of the reference's vmapped
  ``lax.scan``) or ``"numpy"`` (float64, the bit-parity oracle).
* :class:`ScenarioGrid` / :func:`sweep` — declare a grid of (model ×
  device mix × fleet size × link × loss × rate × contention × energy
  budget × compression) scenarios, get back a :class:`SweepResult`.
  ``sweep(backend="cuda")`` runs the fused CUDA kernel (``C`` is never
  materialised) and the dense kernel for energy-budgeted groups.

Conventions are the reference's: ``C[s, k-1, a-1, b-1]`` is the cost of
layers ``[a, b]`` on device ``k`` of scenario ``s`` (+inf = infeasible),
split points are 1-indexed boundaries, and a per-scenario ``n_devices``
vector freezes rows past their own fleet size.

Every entry point takes ``device=None`` (the card; raises without one)
and ``dtype=torch.float32`` (or ``torch.float64``); the ``"numpy"``
backend is float64 on the host and uses neither. Beam and greedy
solvers, multi-channel and variant-bank solves, degradation surfaces,
the planner service and sharding are not ported yet: asking for them
raises ``ValueError``.

Import invariant, as in the reference: ``repro_torch.core`` re-exports
nothing, so ``repro_torch.core.sweep`` is this module; get the function
with ``from repro_torch.core.sweep import sweep``.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, replace
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.latency import (
    BottleneckVariant,
    ContentionModel,
    DeviceProfile,
    LinkProfile,
    ModelCostProfile,
    SplitCostModel,
    bottleneck_variant,
)
from repro_torch.device import resolve_device, resolve_dtype

INF = float("inf")

__all__ = [
    "DP_BACKENDS",
    "BatchedSolverResult",
    "Scenario",
    "ScenarioGrid",
    "SweepResult",
    "SweepRow",
    "apply_energy_budget",
    "batched_optimal_dp",
    "sweep",
]

# Solvers and backends of the reference that later slices port; asking
# for one raises ValueError naming it.
NOT_PORTED = ("batched_beam", "batched_greedy", "jax", "pallas", "sharded")


def _combine_ufunc(combine: str):
    if combine == "sum":
        return np.add
    if combine == "max":
        return np.maximum
    raise ValueError(f"unknown combine {combine!r}")


def _normalize_ns(n_devices, Sn: int, N: int) -> np.ndarray:
    """Per-scenario fleet sizes as an (S,) int64 vector.

    ``None`` means every scenario uses the tensor's full device axis
    ``N``; a scalar broadcasts; a vector must have one entry in
    ``[1, N]`` per scenario (scenario ``s`` then reads only the
    ``C[s, :n_devices[s]]`` prefix)."""
    if n_devices is None:
        return np.full(Sn, N, dtype=np.int64)
    ns = np.asarray(n_devices, dtype=np.int64)
    if ns.ndim == 0:
        ns = np.full(Sn, int(ns), dtype=np.int64)
    if ns.shape != (Sn,):
        raise ValueError(
            f"n_devices must be None, a scalar, or shape ({Sn},); got {ns.shape}")
    if ns.size and (int(ns.min()) < 1 or int(ns.max()) > N):
        raise ValueError(
            f"per-scenario n_devices must lie in [1, {N}], "
            f"got [{int(ns.min())}, {int(ns.max())}]")
    return ns


# ---------------------------------------------------------------------------
# Batched exact DP
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BatchedSolverResult:
    """Result of one batched solve over ``S`` stacked scenarios.

    ``n_devices`` is the solved fleet size (the tensor's device-axis
    length). With a per-scenario fleet-size vector, ``n_devices_s`` holds
    it and scenario ``s``'s configuration spans only its first
    ``n_devices_s[s] - 1`` split columns (the rest stay ``-1``).

    ``wall_time_s`` is the whole batched solve from solver entry through
    result reconstruction (host-device copies and the kernel included),
    excluding input validation and cost assembly (``SweepResult.
    build_time_s`` tracks that); all-k results share one wall."""

    solver: str
    backend: str  # a DP_BACKENDS key
    n_devices: int
    splits: np.ndarray  # (S, N-1) int64, -1 where infeasible/padding
    cost_s: np.ndarray  # (S,) float64 combined objective cost
    feasible: np.ndarray  # (S,) bool
    wall_time_s: float  # one batched pass for ALL scenarios
    n_devices_s: np.ndarray | None = None  # (S,) per-scenario fleet sizes

    @property
    def n_scenarios(self) -> int:
        return int(self.cost_s.shape[0])

    def splits_tuple(self, s: int) -> tuple[int, ...]:
        """Scenario ``s``'s splits in scalar-solver form (``()`` when the
        solver produced no configuration; ``feasible[s]`` is the
        authoritative flag)."""
        width = self.n_devices - 1
        if self.n_devices_s is not None:
            width = int(self.n_devices_s[s]) - 1
        row = self.splits[s, :width]
        if width and (row < 0).any():
            return ()
        return tuple(int(x) for x in row)


def _reconstruct_splits(
    parents: np.ndarray,
    cost: np.ndarray,
    L: int,
    n_devices: int,
    ns: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Walk DP parent pointers back from boundary L (batched).

    With ``ns`` (per-scenario fleet sizes) scenario ``s`` starts its
    walk at its own final device ``ns[s]``; columns beyond
    ``ns[s] - 1`` stay ``-1`` padding."""
    Sn = cost.shape[0]
    feas = np.isfinite(cost)
    splits = np.full((Sn, max(n_devices - 1, 0)), -1, dtype=np.int64)
    b = np.full(Sn, L, dtype=np.int64)
    rows = np.arange(Sn)
    for k in range(n_devices, 1, -1):
        a = parents[rows, k - 2, np.clip(b - 1, 0, L - 1)]
        a = np.where(feas, a, -1)
        if ns is None:
            splits[:, k - 2] = a
            b = np.clip(np.where(feas, a, 1), 1, L)
        else:
            act = ns >= k
            splits[:, k - 2] = np.where(act, a, -1)
            b = np.where(act, np.clip(np.where(feas, a, 1), 1, L), b)
    return splits, feas


def _dp_numpy(C: np.ndarray, combine: str, ns: np.ndarray | None = None):
    """(dp_per_k, parents): dp_per_k[k-1] is the (S, L) DP table after k
    devices; parents[s, k-2, b-1] the argmin boundary. The port's float64
    oracle (first-minimum ties, frozen rows past each ``ns[s]``)."""
    Sn, N, L, _ = C.shape
    comb = _combine_ufunc(combine)
    dp = C[:, 0, 0, :].copy()  # k=1: layers [1..b] on device 1
    dp_per_k = [dp]
    parents = np.full((Sn, max(N - 1, 0), L), -1, dtype=np.int64)
    for k in range(2, N + 1):
        act = None if ns is None else np.flatnonzero(ns >= k)
        if act is not None and act.size == 0:
            break
        if act is None or act.size == Sn:
            # cand[s, a-1, b-1] = comb(dp[s, a], C[s, k, a+1, b]), a=1..L-1
            cand = comb(dp[:, : L - 1, None], C[:, k - 1, 1:L, :])
            ndp = cand.min(axis=1)
            arg = cand.argmin(axis=1) + 1  # boundary a, 1-indexed
            parents[:, k - 2, :] = np.where(np.isfinite(ndp), arg, -1)
            dp = ndp
        else:
            cand = comb(dp[act][:, : L - 1, None], C[act, k - 1, 1:L, :])
            ndp_a = cand.min(axis=1)
            arg = cand.argmin(axis=1) + 1
            parents[act, k - 2, :] = np.where(np.isfinite(ndp_a), arg, -1)
            dp = dp.copy()
            dp[act] = ndp_a
        dp_per_k.append(dp)
    return dp_per_k, parents


def _dp_tables_to_numpy(dp0, dps, args, Sn: int, N: int, L: int):
    """Device DP outputs -> the (dp_per_k, parents) host format every
    result-selection path consumes."""
    dp0 = np.asarray(dp0, dtype=np.float64)
    dp_per_k = [dp0] + [np.asarray(dps[:, i], dtype=np.float64) for i in range(N - 1)]
    parents = np.asarray(args, dtype=np.int64)  # (S, N-1, L)
    if N == 1:
        parents = np.full((Sn, 0, L), -1, dtype=np.int64)
    return dp_per_k, parents


def _validate_dp_inputs(C, return_all_k, n_devices):
    """Shared exact-DP input validation -> (Sn, N, L, ns)."""
    if C.ndim != 4:
        raise ValueError(f"C must be (S, N, L, L), got shape {C.shape}")
    Sn, N, L, L2 = C.shape
    if L != L2:
        raise ValueError(f"C must be square in (a, b), got {C.shape}")
    if return_all_k and n_devices is not None:
        raise ValueError("return_all_k and per-scenario n_devices are "
                         "mutually exclusive")
    ns = None if n_devices is None else _normalize_ns(n_devices, Sn, N)
    return Sn, N, L, ns


def _dp_tables_numpy(C, combine, ns, device, dtype):
    return _dp_numpy(C, combine, ns=ns)


def _dp_tables_torch(C, combine, ns, device, dtype):
    from repro_torch.core import cuda_dp  # lazy: cuda_dp imports this module

    return cuda_dp.plain_dp_tables(C, combine, ns, device=device, dtype=dtype)


def _dp_tables_cuda(C, combine, ns, device, dtype):
    from repro_torch.core import cuda_dp  # lazy: cuda_dp imports this module

    return cuda_dp.cuda_dp_tables(C, combine, ns, device=device, dtype=dtype)


# DP backend registry: each entry maps (C, combine, ns, device, dtype) ->
# (dp_per_k, parents) with the shared frozen-row ``ns`` contract; result
# selection is common (:func:`_results_from_dp_tables`).
DP_BACKENDS: dict[str, Callable] = {
    "numpy": _dp_tables_numpy,  # float64 on the host, the bit-parity oracle
    "torch": _dp_tables_torch,  # the dense kernel's plain PyTorch version
    "cuda": _dp_tables_cuda,    # the dense CUDA kernel
}


def _check_backend(backend: str) -> None:
    if backend in DP_BACKENDS:
        return
    if backend in NOT_PORTED:
        raise ValueError(f"backend {backend!r} is not ported; "
                         f"options: {sorted(DP_BACKENDS)}")
    raise ValueError(f"unknown backend {backend!r}; "
                     f"options: {sorted(DP_BACKENDS)}")


def batched_optimal_dp(
    C: np.ndarray,
    combine: str = "sum",
    backend: str = "cuda",
    return_all_k: bool = False,
    n_devices: np.ndarray | Sequence[int] | int | None = None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
):
    """Exact split DP over a stacked cost tensor — one pass, every scenario.

    Args:
      C: ``(S, N, L, L)`` float64 stacked cost tensor (+inf = infeasible).
      combine: ``"sum"`` (Eq. 5 latency) or ``"max"`` (bottleneck).
      backend: a :data:`DP_BACKENDS` key.
      return_all_k: return ``{n: result}`` for every fleet size
        ``n = 1..N`` from the one solve.
      n_devices: optional per-scenario fleet sizes (see
        :func:`_normalize_ns`); mutually exclusive with ``return_all_k``.
      device / dtype: where and in which type the ``"cuda"`` and
        ``"torch"`` backends run (``C`` is cast after assembly in float64).

    ``backend="numpy"`` is the float64 oracle; ``"torch"`` and ``"cuda"``
    in float64 are bit-identical to it, and in float32 bit-identical to
    each other (and to the reference's ``"jax"``/``"pallas"`` backends)."""
    Sn, N, L, ns = _validate_dp_inputs(C, return_all_k, n_devices)
    t0 = time.perf_counter()
    _check_backend(backend)
    dp_per_k, parents = DP_BACKENDS[backend](C, combine, ns, device, dtype)
    return _results_from_dp_tables(dp_per_k, parents, L, N, Sn, backend,
                                   ns, return_all_k, t0)


def _results_from_dp_tables(
    dp_per_k: list[np.ndarray],
    parents: np.ndarray,
    L: int,
    N: int,
    Sn: int,
    backend: str,
    ns: np.ndarray | None,
    return_all_k: bool,
    t0: float,
) -> BatchedSolverResult | dict[int, BatchedSolverResult]:
    """Shared DP result selection + reconstruction (all backends);
    ``wall_time_s`` is stamped after reconstruction."""

    def result_for(n: int) -> BatchedSolverResult:
        cost = dp_per_k[n - 1][:, L - 1].astype(np.float64, copy=True)
        splits, feas = _reconstruct_splits(parents, cost, L, n)
        return BatchedSolverResult(
            solver="batched_dp", backend=backend, n_devices=n,
            splits=splits, cost_s=cost, feasible=feas, wall_time_s=0.0,
        )

    if return_all_k:
        out = {n: result_for(n) for n in range(1, N + 1)}
        wall = time.perf_counter() - t0
        return {n: replace(r, wall_time_s=wall) for n, r in out.items()}
    if ns is not None:
        dpk = np.stack([d[:, L - 1] for d in dp_per_k])  # (N, S)
        cost = dpk[ns - 1, np.arange(Sn)].astype(np.float64, copy=True)
        splits, feas = _reconstruct_splits(parents, cost, L, N, ns=ns)
        return BatchedSolverResult(
            solver="batched_dp", backend=backend, n_devices=N,
            splits=splits, cost_s=cost, feasible=feas,
            wall_time_s=time.perf_counter() - t0, n_devices_s=ns,
        )
    return replace(result_for(N), wall_time_s=time.perf_counter() - t0)


def apply_energy_budget(
    C: np.ndarray,
    E: np.ndarray,
    energy_budget: float | np.ndarray | Sequence[float] | None,
) -> np.ndarray:
    """Mask the latency tensor ``C`` to +inf wherever the matching energy
    tensor ``E`` exceeds the per-device ``energy_budget``.

    ``None`` or +inf means unconstrained (``C`` is returned untouched);
    a scalar applies to every scenario; an ``(S,)`` vector gives each
    scenario its own budget. The comparison is the strict ``E > budget``
    of the reference."""
    if energy_budget is None:
        return C
    b = np.asarray(energy_budget, dtype=np.float64)
    if b.ndim == 0:
        if float(b) == INF:
            return C
        b = np.full(C.shape[0], float(b))
    if b.shape != (C.shape[0],):
        raise ValueError(
            f"energy_budget must be None, a scalar, or shape "
            f"({C.shape[0]},); got {b.shape}")
    if E.shape != C.shape:
        raise ValueError(f"energy tensor shape {E.shape} != cost tensor "
                         f"shape {C.shape}")
    return np.where(E > b[:, None, None, None], INF, C)


# ---------------------------------------------------------------------------
# ScenarioGrid — the fleet-sweep API
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Scenario:
    """One point of a :class:`ScenarioGrid` (a what-if the planner prices).

    ``mix`` names the device mix this scenario's fleet draws from
    (``None`` = the grid's shared ``devices`` tuple); ``contention`` is
    the number of devices time-sharing the channel (1 = uncontended);
    ``energy_budget`` the per-device Joule cap (``None`` = unconstrained);
    ``compression`` the bottleneck compression factor (1.0 = identity)."""

    model: str
    protocol: str
    n_devices: int
    loss_p: float | None  # None -> protocol default
    rate_scale: float  # multiplier on the link serialization rate
    mix: str | None = None  # device-mix name (None -> grid.devices)
    contention: int = 1  # concurrent transmitters sharing the channel
    energy_budget: float | None = None  # per-device Joule cap
    compression: float = 1.0  # bottleneck compression factor (1.0 = identity)

    def describe(self) -> str:
        loss = "base" if self.loss_p is None else f"p={self.loss_p:g}"
        mix = "" if self.mix is None else f" mix={self.mix}"
        con = "" if self.contention <= 1 else f" tx={self.contention}"
        eb = "" if self.energy_budget is None else f" E<={self.energy_budget:g}J"
        cx = "" if self.compression == 1.0 else f" cx{self.compression:g}"
        return (f"{self.model}/{self.protocol} N={self.n_devices} "
                f"{loss} rate×{self.rate_scale:g}{mix}{con}{eb}{cx}")


@dataclass(frozen=True)
class ScenarioGrid:
    """A dense grid of split-planning scenarios:
    models × device mixes × fleet sizes × links × loss rates × rate scales
    × contention groups × energy budgets × compression factors.

    ``models`` maps names to :class:`ModelCostProfile`; ``links`` maps
    protocol names to :class:`LinkProfile`; ``devices`` is the device
    profile tuple shared by all scenarios (one profile broadcasts over any
    fleet size). ``device_mixes`` adds a heterogeneous-fleet axis (mix
    name -> profile tuple; a multi-profile mix must cover the grid's
    largest fleet size). ``contention_groups`` adds a shared-channel axis
    (see :class:`ContentionModel`), ``energy_budgets`` a per-device Joule
    cap axis, ``compression_factors`` the bottleneck-variant axis (built
    with the grid's ``variant_*`` knobs via :func:`bottleneck_variant`)."""

    models: Mapping[str, ModelCostProfile]
    links: Mapping[str, LinkProfile]
    n_devices: tuple[int, ...]
    loss_p: tuple[float | None, ...] = (None,)
    rate_scale: tuple[float, ...] = (1.0,)
    devices: tuple[DeviceProfile, ...] = ()
    objective: str = "sum"
    device_mixes: Mapping[str, tuple[DeviceProfile, ...]] | None = None
    contention_groups: tuple[int, ...] = (1,)
    energy_budgets: tuple[float | None, ...] = (None,)
    mac_efficiency: float = 1.0  # shared-channel MAC efficiency
    compression_factors: tuple[float, ...] = (1.0,)
    variant_encoder_t_s: float = 0.0  # fixed encoder latency per cut
    variant_encoder_s_per_byte: float = 0.0  # linear encoder latency per byte
    variant_accuracy_drop: float = 0.03  # accuracy-proxy drop per octave

    def __post_init__(self):
        if not self.devices and not self.device_mixes:
            raise ValueError("ScenarioGrid requires devices or device_mixes")
        for field_name in ("n_devices", "loss_p", "rate_scale",
                           "contention_groups", "energy_budgets",
                           "compression_factors"):
            object.__setattr__(self, field_name, tuple(getattr(self, field_name)))
        for g in self.contention_groups:
            if g < 1:
                raise ValueError(f"contention group must be >= 1, got {g}")
        for cf in self.compression_factors:
            if cf < 1.0:
                raise ValueError(
                    f"compression factor must be >= 1, got {cf}")
        object.__setattr__(self, "models", dict(self.models))
        object.__setattr__(self, "links", dict(self.links))
        if self.device_mixes is not None:
            mixes = {name: tuple(m) for name, m in dict(self.device_mixes).items()}
            n_max = max(self.n_devices) if self.n_devices else 0
            for name, m in mixes.items():
                if not m:
                    raise ValueError(f"device mix {name!r} is empty")
                if 1 < len(m) < n_max:
                    raise ValueError(
                        f"device mix {name!r} has {len(m)} profiles but the "
                        f"grid asks for up to {n_max} devices (a single "
                        f"profile broadcasts; several must cover every "
                        f"fleet size)")
            object.__setattr__(self, "device_mixes", mixes)

    @property
    def mix_names(self) -> tuple[str | None, ...]:
        """The device-mix axis: ``(None,)`` when homogeneous; with
        ``device_mixes``, the named mixes, after a leading ``None`` for
        the shared ``devices`` fleet when that is also given."""
        if self.device_mixes:
            base: tuple[str | None, ...] = (None,) if self.devices else ()
            return base + tuple(self.device_mixes)
        return (None,)

    @property
    def size(self) -> int:
        return (len(self.models) * len(self.links) * len(self.n_devices)
                * len(self.loss_p) * len(self.rate_scale)
                * len(self.mix_names) * len(self.contention_groups)
                * len(self.energy_budgets) * len(self.compression_factors))

    def scenarios(self) -> list[Scenario]:
        """Deterministic enumeration order: model-major, then device mix,
        then fleet size, then protocol × loss × rate × contention ×
        energy budget × compression."""
        return [
            Scenario(m, p, n, lp, rs, mix=mx, contention=cg, energy_budget=eb,
                     compression=cf)
            for m in self.models
            for mx in self.mix_names
            for n in self.n_devices
            for p in self.links
            for lp in self.loss_p
            for rs in self.rate_scale
            for cg in self.contention_groups
            for eb in self.energy_budgets
            for cf in self.compression_factors
        ]

    def link_variant(self, sc: Scenario) -> LinkProfile:
        """The protocol's base link with the scenario's loss (``None``
        keeps the base loss) and rate scale applied."""
        link = self.links[sc.protocol]
        changes: dict = {}
        if sc.loss_p is not None:
            changes["loss_p"] = sc.loss_p
        if sc.rate_scale != 1.0:
            changes["rate_bytes_per_s"] = link.rate_bytes_per_s * sc.rate_scale
        return replace(link, **changes) if changes else link

    def contention_model(self, sc: Scenario) -> ContentionModel | None:
        """The scenario's shared-channel schedule (``None`` for a group
        of 1)."""
        if sc.contention <= 1:
            return None
        return ContentionModel(transmitters=sc.contention,
                               mac_efficiency=self.mac_efficiency)

    def effective_link(self, sc: Scenario) -> LinkProfile:
        """:meth:`link_variant` with the scenario's contention applied."""
        link = self.link_variant(sc)
        con = self.contention_model(sc)
        return link if con is None else con.apply(link)

    def devices_for(self, sc: Scenario) -> tuple[DeviceProfile, ...]:
        """The device-profile tuple scenario ``sc``'s fleet runs on."""
        if sc.mix is not None:
            return self.device_mixes[sc.mix]
        return self.devices

    def variant_for(self, sc: Scenario) -> BottleneckVariant | None:
        """The scenario's bottleneck variant (``None`` for factor 1.0)."""
        if sc.compression == 1.0:
            return None
        return bottleneck_variant(
            sc.compression,
            encoder_t_s=self.variant_encoder_t_s,
            encoder_s_per_byte=self.variant_encoder_s_per_byte,
            accuracy_drop_per_octave=self.variant_accuracy_drop,
        )

    def accuracy_for(self, sc: Scenario) -> float:
        """The scenario's accuracy proxy (1.0 for the identity variant)."""
        v = self.variant_for(sc)
        return 1.0 if v is None else v.accuracy_proxy

    def cost_model(self, sc: Scenario) -> SplitCostModel:
        """The scalar :class:`SplitCostModel` for one scenario."""
        return SplitCostModel(
            profile=self.models[sc.model], devices=self.devices_for(sc),
            link=self.link_variant(sc), objective=self.objective,
            contention=self.contention_model(sc),
            variant=self.variant_for(sc),
        )

    def degradation_surface(self, *args, **kwargs):
        raise ValueError("degradation_surface is not ported yet")

    def degradation_surfaces(self, *args, **kwargs):
        raise ValueError("degradation_surfaces is not ported yet")


@dataclass(frozen=True)
class SweepRow:
    """Per-scenario best plan from a sweep."""

    scenario: Scenario
    splits: tuple[int, ...]
    feasible: bool
    objective_cost_s: float  # solver objective (no setup/feedback)
    total_latency_s: float  # Eq. 8 incl. link setup + feedback overheads
    device_s: float  # summed device-local segment latency
    transmission_s: float  # summed cut transmission + encoder latency
    solver_wall_s: float  # this scenario's share of the batched solve
    accuracy_proxy: float = 1.0  # the scenario variant's accuracy proxy

    def to_dict(self) -> dict:
        d = dict(self.scenario.__dict__)
        d.update(
            splits=list(self.splits), feasible=self.feasible,
            objective_cost_s=self.objective_cost_s,
            total_latency_s=self.total_latency_s,
            device_s=self.device_s, transmission_s=self.transmission_s,
            solver_wall_s=self.solver_wall_s,
            accuracy_proxy=self.accuracy_proxy,
        )
        return d


@dataclass(frozen=True)
class SweepResult:
    """Dense sweep output: one row per scenario, grid order preserved."""

    rows: tuple[SweepRow, ...]
    solver: str
    backend: str
    solve_time_s: float  # batched solver passes only
    build_time_s: float  # cost assembly on the host

    @property
    def n_scenarios(self) -> int:
        return len(self.rows)

    @property
    def scenarios_per_sec(self) -> float:
        total = self.solve_time_s + self.build_time_s
        return self.n_scenarios / total if total > 0 else INF

    def best(self, **filters) -> SweepRow:
        """Lowest-latency feasible row among those matching scenario-field
        filters, e.g. ``best(model="mobilenet_v2", n_devices=4)``."""
        pool = [
            r for r in self.rows
            if r.feasible
            and all(getattr(r.scenario, k) == v for k, v in filters.items())
        ]
        if not pool:
            raise LookupError(f"no feasible scenario matches {filters!r}")
        return min(pool, key=lambda r: r.total_latency_s)

    def to_dicts(self) -> list[dict]:
        return [r.to_dict() for r in self.rows]

    def to_json(self, indent: int | None = None) -> str:
        def _clean(v):
            return None if isinstance(v, float) and not np.isfinite(v) else v

        payload = {
            "solver": self.solver, "backend": self.backend,
            "n_scenarios": self.n_scenarios,
            "solve_time_s": self.solve_time_s, "build_time_s": self.build_time_s,
            "scenarios_per_sec": self.scenarios_per_sec,
            "rows": [{k: _clean(v) for k, v in d.items()} for d in self.to_dicts()],
        }
        return json.dumps(payload, indent=indent)


def _group_tx_vectors(
    grid: ScenarioGrid, profile: ModelCostProfile, group: list[Scenario]
) -> tuple[np.ndarray, np.ndarray | None, np.ndarray | None]:
    """(S_g, L) transmission-cost vectors, amortizing packet counts per
    (MTU, compression factor) against per-scenario packet times, priced on
    each scenario's contention-scaled link; a bottleneck variant prices
    packets on the compressed cut bytes and adds the encoder time.

    Returns ``(TX, AIR, ENC)``: ``TX`` is what the latency tensor adds
    (airtime + encoder time); ``AIR``/``ENC`` split it for the energy
    tensor and are ``None`` when no scenario in the group has a variant."""
    L = profile.num_layers
    act_raw = profile.segment_arrays.boundary_act_bytes[1:].astype(np.float64)
    variants = [grid.variant_for(sc) for sc in group]
    any_variant = any(v is not None for v in variants)
    packets_by_key: dict[tuple[int, float], np.ndarray] = {}
    enc_by_factor: dict[float, np.ndarray] = {}
    out = np.empty((len(group), L))
    air_out = np.empty((len(group), L)) if any_variant else None
    enc_out = np.zeros((len(group), L)) if any_variant else None
    for i, (sc, v) in enumerate(zip(group, variants)):
        link = grid.effective_link(sc)
        factor = 1.0 if v is None else v.compression_factor
        K = packets_by_key.get((link.mtu_bytes, factor))
        if K is None:
            if v is None:
                act = act_raw
            else:
                act = np.where(act_raw > 0,
                               np.ceil(act_raw / v.compression_factor), 0.0)
            K = np.where(act > 0, np.ceil(act / link.mtu_bytes), 0.0)
            packets_by_key[(link.mtu_bytes, factor)] = K
        tx = K * link.packet_time_s()
        tx[-1] = 0.0
        if air_out is not None:
            air_out[i] = tx
        if v is not None:
            enc = enc_by_factor.get(factor)
            if enc is None:
                enc = np.where(act_raw > 0,
                               v.encoder_t_s + act_raw * v.encoder_s_per_byte,
                               0.0)
                enc[-1] = 0.0
                enc_by_factor[factor] = enc
            enc_out[i] = enc
            tx = tx + enc
        out[i] = tx
    return out, air_out, enc_out


def _group_energy_tensor(
    grid: ScenarioGrid,
    group: list[Scenario],
    bank: np.ndarray,
    bank_rows: Mapping[tuple[DeviceProfile, bool], int],
    bank_idx: np.ndarray,
    AIR: np.ndarray,
    ENC: np.ndarray | None = None,
) -> np.ndarray:
    """(S_g, N_max, L, L) energy tensor for one sweep group, from the same
    profile bank and transmission vectors as the latency tensor, in the
    reference's operation order (power × airtime, tx then rx); filler
    slots beyond a scenario's fleet size are never read."""
    L = AIR.shape[1]
    row_power = np.zeros(len(bank), dtype=np.float64)
    for (dev, _is_first), row in bank_rows.items():
        row_power[row] = dev.active_power_w
    with np.errstate(invalid="ignore"):
        e_bank = np.where(np.isfinite(bank),
                          row_power[:, None, None] * bank, INF)
    E = e_bank[bank_idx]  # (S_g, N_max, L, L)
    if ENC is not None:
        pw = row_power[bank_idx]  # (S_g, N_max) per-slot active power
        E = E + pw[:, :, None, None] * ENC[:, None, None, :]
    rx_t = np.zeros_like(AIR)
    rx_t[:, 1:] = AIR[:, : L - 1]  # [a-1] = airtime of the cut entering at a
    tx_p = np.array([grid.effective_link(sc).tx_power_w for sc in group])
    rx_p = np.array([grid.effective_link(sc).rx_power_w for sc in group])
    E = E + (tx_p[:, None] * AIR)[:, None, None, :]
    E = E + (rx_p[:, None] * rx_t)[:, None, :, None]
    return E


def sweep(
    grid: ScenarioGrid,
    solver: str = "batched_dp",
    backend: str = "cuda",
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> SweepResult:
    """Plan every scenario of ``grid`` with the exact split DP.

    Args:
      grid: the scenario grid to price.
      solver: ``"batched_dp"`` (the only solver ported so far).
      backend: ``"cuda"`` (the fused kernel builds ``C[s,k] = bank[idx] +
        TX[s]`` inside its reduction, ``C`` never materialised; energy-
        budgeted groups mask a materialised ``C`` and run the dense
        kernel), ``"torch"`` (the dense plain version on a materialised
        ``C``) or ``"numpy"`` (float64 oracle on the host).
      device / dtype: see the module docstring.

    Scenarios are grouped by model; within a group every fleet size and
    device mix stacks into one solve (per-device cost matrices come from
    a bank with one entry per distinct ``(DeviceProfile, is_first)``
    pair, smaller fleets ride the per-scenario ``n_devices`` vector).
    Row order equals ``grid.scenarios()`` order."""
    if solver != "batched_dp":
        if solver in NOT_PORTED:
            raise ValueError(f"solver {solver!r} is not ported; the port "
                             f"sweeps with 'batched_dp' only")
        raise ValueError(f"unknown batched solver {solver!r}; "
                         f"options: ['batched_dp']")
    _check_backend(backend)
    if backend != "numpy":
        device, dtype = resolve_device(device), resolve_dtype(dtype)
    combine = "max" if grid.objective == "bottleneck" else "sum"
    order = grid.scenarios()
    groups: dict[str, list[int]] = {}
    for idx, sc in enumerate(order):
        groups.setdefault(sc.model, []).append(idx)

    rows: dict[int, SweepRow] = {}
    build_time = 0.0
    solve_time = 0.0
    for model_name, idxs in groups.items():
        profile = grid.models[model_name]
        L = profile.num_layers
        group = [order[i] for i in idxs]
        t0 = time.perf_counter()
        n_max = max(sc.n_devices for sc in group)
        ns = np.array([sc.n_devices for sc in group], dtype=np.int64)
        base_model = SplitCostModel(
            profile=profile, devices=grid.devices_for(group[0]),
            link=next(iter(grid.links.values())), objective=grid.objective,
        )
        # profile bank: one local matrix per (device profile, is-first)
        bank_rows: dict[tuple[DeviceProfile, bool], int] = {}
        bank_mats: list[np.ndarray] = []

        def bank_index(dev: DeviceProfile, is_first: bool) -> int:
            key = (dev, is_first)
            row = bank_rows.get(key)
            if row is None:
                row = len(bank_mats)
                bank_rows[key] = row
                bank_mats.append(base_model._local_cost_matrix(dev, is_first))
            return row

        bank_idx = np.zeros((len(group), n_max), dtype=np.int64)
        for gi, sc in enumerate(group):
            devs = grid.devices_for(sc)
            for k in range(1, sc.n_devices + 1):
                dev = devs[0] if len(devs) == 1 else devs[k - 1]
                bank_idx[gi, k - 1] = bank_index(dev, k == 1)
            # slots beyond a scenario's own fleet size keep row 0 filler:
            # the solvers never read them
        TX, AIR, ENC = _group_tx_vectors(grid, profile, group)  # (S_g, L)
        bank = np.stack(bank_mats)
        budgets = np.array(
            [INF if sc.energy_budget is None else float(sc.energy_budget)
             for sc in group])
        budgeted = bool(np.isfinite(budgets).any())
        if backend == "cuda" and not budgeted:
            build_time += time.perf_counter() - t0
            from repro_torch.core import cuda_dp  # lazy: it imports this module

            res = cuda_dp.cuda_fused_optimal_dp(
                bank, bank_idx, TX, combine=combine, n_devices=ns,
                device=device, dtype=dtype)
        else:
            if bool((bank_idx == bank_idx[0]).all()):
                # homogeneous group: broadcast one local tensor
                local = bank[bank_idx[0]]  # (N_max, L, L)
                C = local[None, :, :, :] + TX[:, None, None, :]
            else:
                C = bank[bank_idx]  # (S_g, N_max, L, L) gather
                C += TX[:, None, None, :]
            if budgeted:
                E = _group_energy_tensor(grid, group, bank, bank_rows,
                                         bank_idx,
                                         AIR if AIR is not None else TX, ENC)
                C = apply_energy_budget(C, E, budgets)
            build_time += time.perf_counter() - t0
            res = batched_optimal_dp(C, combine=combine, backend=backend,
                                     n_devices=ns, device=device, dtype=dtype)
        solve_time += res.wall_time_s
        per_scn_wall = res.wall_time_s / max(1, len(group))

        # cost breakdowns from the bank + TX decomposition (bitwise equal
        # to the C entries, built as exactly this float64 sum)
        for gi, (idx, sc) in enumerate(zip(idxs, group)):
            n = sc.n_devices
            splits_t = res.splits_tuple(gi)
            feasible = bool(res.feasible[gi])
            link = grid.effective_link(sc)
            if splits_t or n == 1:
                bounds = [0, *splits_t, L] if feasible else None
            else:
                bounds = None
            if feasible and bounds is not None:
                tx_total = float(np.sum(TX[gi, [b - 1 for b in bounds[1:-1]]])) \
                    if len(bounds) > 2 else 0.0
                obj = float(res.cost_s[gi])
                seg_sum = float(sum(
                    bank[bank_idx[gi, i], bounds[i], bounds[i + 1] - 1]
                    + TX[gi, bounds[i + 1] - 1]
                    for i in range(len(bounds) - 1)))
                device_s = seg_sum - tx_total
                total = obj + link.t_setup_s + link.t_feedback_s
                rows[idx] = SweepRow(
                    scenario=sc, splits=splits_t, feasible=True,
                    objective_cost_s=obj, total_latency_s=total,
                    device_s=device_s, transmission_s=tx_total,
                    solver_wall_s=per_scn_wall,
                    accuracy_proxy=grid.accuracy_for(sc),
                )
            else:
                rows[idx] = SweepRow(
                    scenario=sc, splits=splits_t, feasible=False,
                    objective_cost_s=INF, total_latency_s=INF,
                    device_s=INF, transmission_s=INF,
                    solver_wall_s=per_scn_wall,
                    accuracy_proxy=grid.accuracy_for(sc),
                )
    ordered = tuple(rows[i] for i in range(len(order)))
    return SweepResult(rows=ordered, solver=solver, backend=backend,
                       solve_time_s=solve_time, build_time_s=build_time)
