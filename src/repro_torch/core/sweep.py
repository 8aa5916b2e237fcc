"""Fleet-scale scenario sweeps and batched solves, the DP on the card.

The port's counterpart of ``repro.core.sweep``:

* :func:`batched_optimal_dp` — the exact O(L² N) split DP over a stacked
  scenario axis, on one of :data:`DP_BACKENDS`: ``"cuda"`` (the dense
  CUDA kernel, :mod:`repro_torch.core.cuda_dp`), ``"torch"`` (its plain
  PyTorch version, the counterpart of the reference's vmapped
  ``lax.scan``) or ``"numpy"`` (float64, the bit-parity oracle).
* :func:`batched_beam_search` / :func:`batched_greedy_search` (and their
  ``_all_k`` forms) — the paper's Algorithm 1/2 heuristics vectorized
  over scenarios: numpy on the host, as in the reference, line for line.
* :func:`solve_batched`, :func:`solve_multi_channel` and
  :func:`solve_variant_bank` — the batched solve family (energy budgets,
  weighted channel combines, bottleneck-variant banks with an accuracy
  floor); :func:`batched_total_cost` scores split sets across scenarios.
* :class:`ScenarioGrid` / :func:`sweep` — declare a grid of (model ×
  device mix × fleet size × link × loss × rate × contention × energy
  budget × compression) scenarios, get back a :class:`SweepResult`
  (rows, CSV, Pareto frontiers). ``sweep(backend="cuda")`` runs the
  fused CUDA kernel (``C`` is never materialised) and the dense kernel
  for energy-budgeted groups; :func:`sweep_scalar` is the per-scenario
  scalar loop and :func:`parity_report` compares two sweeps.

Conventions are the reference's: ``C[s, k-1, a-1, b-1]`` is the cost of
layers ``[a, b]`` on device ``k`` of scenario ``s`` (+inf = infeasible),
split points are 1-indexed boundaries, and a per-scenario ``n_devices``
vector freezes rows past their own fleet size.

Backends: ``backend=None`` means ``"cuda"`` for ``solver="batched_dp"``
and ``"numpy"`` for ``batched_beam`` / ``batched_greedy``, which are host
numpy algorithms and refuse any other backend (``ValueError``), as the
reference does. The DP's ``"cuda"`` and ``"torch"`` backends take
``device=None`` (the card; ``RuntimeError`` without one) and
``dtype=torch.float32`` (or ``torch.float64``); ``"numpy"`` is float64 on
the host and uses neither. The reference's ``"jax"``, ``"pallas"`` and
``"sharded"`` backends are refused by name (:data:`NOT_PORTED`).

The reference's ``solve_batched``, ``solve_multi_channel`` and
``solve_variant_bank`` are shims over its planner tier
(``repro.core.spec.PlannerService``), which the port does not have yet:
here each calls its ``_impl`` directly, under the reference's ``_impl``
name and signature.

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

from repro_torch.core import solvers as S
from repro_torch.core.latency import (
    COST_CHANNELS,
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
    "BATCHED_SOLVERS",
    "DP_BACKENDS",
    "BatchedSolverResult",
    "ParetoFrontier",
    "Scenario",
    "ScenarioGrid",
    "SweepResult",
    "SweepRow",
    "apply_accuracy_floor",
    "apply_energy_budget",
    "batched_beam_search",
    "batched_beam_search_all_k",
    "batched_greedy_search",
    "batched_greedy_search_all_k",
    "batched_optimal_dp",
    "batched_total_cost",
    "combine_channels",
    "pareto_frontier",
    "parity_report",
    "solve_batched",
    "solve_multi_channel",
    "solve_variant_bank",
    "stack_cost_tensors",
    "sweep",
    "sweep_scalar",
]

# Backends of the reference that the port does not have; asking for one
# raises ValueError naming it.
NOT_PORTED = ("jax", "pallas", "sharded")


# ---------------------------------------------------------------------------
# Tensor utilities
# ---------------------------------------------------------------------------


def stack_cost_tensors(
    models: Sequence[SplitCostModel],
    n_devices: int | Sequence[int],
    channels: Sequence[str] | None = None,
    variants: Sequence[BottleneckVariant] | None = None,
) -> np.ndarray:
    """Stack per-scenario cost tensors into ``(S, N, L, L)``.

    All models must share the same layer count ``L`` (same model graph;
    links/devices may differ) — that is what makes the scenario axis
    dense. ``n_devices`` may be one fleet size for all models or one
    per model: each tensor is then exported at its OWN size (so a
    model's device tuple only has to cover its own fleet) and padded
    with +inf device slices up to the largest — slices the solvers
    never read under a matching per-scenario ``n_devices`` vector.

    ``channels``: optional sequence drawn from
    :data:`repro_torch.core.latency.COST_CHANNELS`. When given, the result is
    the stacked multi-channel tensor ``C[ch, s, k-1, a-1, b-1]`` of
    shape (len(channels), S, N, L, L); each channel slice is
    bit-identical to the single-channel stack of that channel (the
    degenerate one-channel case therefore IS the historical tensor).

    ``variants``: optional bottleneck-variant bank (see
    :class:`repro_torch.core.latency.BottleneckVariant`). When given, the
    result grows a leading variant axis — ``C[v, s, k-1, a-1, b-1]`` of
    shape (V, S, N, L, L) — where slice ``v`` is the stack of
    ``replace(m, variant=variants[v])`` tensors, i.e. each variant
    reprices the cut payload (compressed bytes + encoder time) while
    the local compute term is shared. Slice 0 of an identity-leading
    bank is bit-identical to the variant-free stack. Mutually exclusive
    with ``channels`` (mask/solve one concern at a time; energy budgets
    under a variant bank stack the energy channel per variant). Feed
    the result to :func:`solve_variant_bank`."""
    if channels is not None and variants is not None:
        raise ValueError("stack_cost_tensors: channels and variants are "
                         "mutually exclusive; stack channels per variant")
    if variants is not None:
        if not variants:
            raise ValueError("variants bank must not be empty")
        return np.stack([
            stack_cost_tensors([replace(m, variant=v) for m in models],
                               n_devices)
            for v in variants
        ], axis=0)
    if isinstance(n_devices, (int, np.integer)):
        n_list = [int(n_devices)] * len(models)
    else:
        n_list = [int(n) for n in n_devices]
        if len(n_list) != len(models):
            raise ValueError(f"n_devices has {len(n_list)} entries for "
                             f"{len(models)} models")
    if not models:
        raise ValueError("stack_cost_tensors needs at least one model")
    n_max = max(n_list)
    tensors = []
    for m, n in zip(models, n_list):
        t = m.segment_cost_tensor(n, channels=channels)
        if n < n_max:
            pad_axis = 0 if channels is None else 1
            pad_shape = list(t.shape)
            pad_shape[pad_axis] = n_max - n
            t = np.concatenate([t, np.full(tuple(pad_shape), INF)],
                               axis=pad_axis)
        tensors.append(t)
    Ls = {t.shape[-1] for t in tensors}
    if len(Ls) != 1:
        raise ValueError(f"scenario tensors disagree on L: {sorted(Ls)}")
    return np.stack(tensors, axis=0 if channels is None else 1)


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
    ``C[s, :n_devices[s]]`` prefix — device ``k``'s cost matrix never
    depends on the fleet size, so prefixes of one stacked tensor are
    exact sub-problems)."""
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


def batched_total_cost(
    C: np.ndarray, splits: np.ndarray, combine: str = "sum"
) -> np.ndarray:
    """Score candidate split sets across every scenario at once.

    ``C``: (S, N, L, L) stacked cost tensor; ``splits``: (M, N-1) int
    array of candidate configurations (1-indexed boundaries). Returns
    (S, M) combined costs, +inf for invalid/infeasible candidates —
    the batched counterpart of :func:`repro_torch.core.solvers.total_cost`."""
    Sn, N, L, _ = C.shape
    splits = np.asarray(splits, dtype=np.int64)
    if splits.ndim == 1:
        splits = splits[None, :]
    M = splits.shape[0]
    if splits.shape[1] != N - 1:
        raise ValueError(f"splits must have N-1={N - 1} columns, got {splits.shape}")
    bounds = np.concatenate(
        [np.zeros((M, 1), np.int64), splits, np.full((M, 1), L, np.int64)], axis=1
    )  # (M, N+1)
    valid = np.all(bounds[:, 1:] > bounds[:, :-1], axis=1)  # strictly increasing
    safe = np.clip(bounds, 0, L)
    k_idx = np.arange(N)[None, :]  # (1, N)
    a_idx = np.clip(safe[:, :-1], 0, L - 1)  # segment start boundary (a-1 index)
    b_idx = np.clip(safe[:, 1:] - 1, 0, L - 1)
    seg = C[:, k_idx, a_idx, b_idx]  # (S, M, N)
    if combine == "sum":
        total = np.cumsum(seg, axis=2)[:, :, -1]  # sequential, matches scalar sum
    else:
        total = np.max(seg, axis=2)
    total = np.where(valid[None, :], total, INF)
    return total


def _per_scenario_total_cost(
    C: np.ndarray,
    splits: np.ndarray,
    combine: str = "sum",
    n_devices_s: np.ndarray | None = None,
) -> np.ndarray:
    """Combined cost of scenario ``s``'s OWN configuration ``splits[s]``
    (shape (S, N-1) -> (S,)); +inf for non-increasing bounds.

    With ``n_devices_s`` only scenario ``s``'s first ``n_s - 1`` split
    columns are read; trailing boundaries collapse to ``L`` and the
    dead segments contribute the combine identity (``+0.0`` for sum —
    bit-preserving on the non-negative costs the latency model emits —
    and ``-inf`` for max), so totals stay bit-identical to a scalar
    walk over the live segments only."""
    Sn, N, L, _ = C.shape
    ns = _normalize_ns(n_devices_s, Sn, N)
    splits = np.asarray(splits, np.int64)
    j = np.arange(1, N)[None, :]  # boundary number of split column j-1
    mid = np.where(j <= ns[:, None] - 1, splits, L)
    bounds = np.concatenate(
        [np.zeros((Sn, 1), np.int64), mid, np.full((Sn, 1), L, np.int64)],
        axis=1,
    )  # (S, N+1)
    live = np.arange(N)[None, :] < ns[:, None]  # (S, N) live segments
    valid = np.all(np.where(live, bounds[:, 1:] > bounds[:, :-1], True), axis=1)
    a_idx = np.clip(bounds[:, :-1], 0, L - 1)
    b_idx = np.clip(bounds[:, 1:] - 1, 0, L - 1)
    seg = C[np.arange(Sn)[:, None], np.arange(N)[None, :], a_idx, b_idx]  # (S, N)
    if combine == "sum":
        seg = np.where(live, seg, 0.0)
        total = np.cumsum(seg, axis=1)[:, -1]  # sequential, matches scalar sum
    else:
        seg = np.where(live, seg, -INF)
        total = seg.max(axis=1)
    return np.where(valid, total, INF)
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
    build_time_s`` tracks that); all-k results share one wall.

    Multi-channel solves (:func:`solve_multi_channel`) add the chosen
    plan's per-channel totals, ``channel_cost_s[ch, s]``; variant-bank
    solves (:func:`solve_variant_bank`) add the winning bank index
    ``variant[s]`` (-1 where no variant is feasible)."""

    solver: str
    backend: str  # a DP_BACKENDS key for batched_dp; "numpy" otherwise
    n_devices: int
    splits: np.ndarray  # (S, N-1) int64, -1 where infeasible/padding
    cost_s: np.ndarray  # (S,) float64 combined objective cost
    feasible: np.ndarray  # (S,) bool
    wall_time_s: float  # one batched pass for ALL scenarios
    n_devices_s: np.ndarray | None = None  # (S,) per-scenario fleet sizes
    channels: tuple[str, ...] | None = None
    channel_cost_s: np.ndarray | None = None  # (n_channels, S) float64
    variant: np.ndarray | None = None  # (S,) int64

    @property
    def n_scenarios(self) -> int:
        return int(self.cost_s.shape[0])

    def splits_tuple(self, s: int) -> tuple[int, ...]:
        """Scenario ``s``'s splits in scalar-solver form (``()`` when the
        solver produced no configuration; like the scalar greedy, a full
        configuration whose total is +inf keeps its split points:
        ``feasible[s]`` is the authoritative flag)."""
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


# ---------------------------------------------------------------------------
# Feasibility lookahead (vectorized _min_devices_suffix)
# ---------------------------------------------------------------------------


def _min_devices_suffix_batched(C: np.ndarray) -> np.ndarray:
    """need[s, j] = minimum devices that can host layers [j..L] feasibly
    (+inf if none) — the vectorized twin of
    :func:`repro_torch.core.solvers._min_devices_suffix` (probe device k=2,
    falling back to k=1 when only one device slice exists).

    Depends only on the probe slice, so callers that tile one base
    tensor across a fleet-size axis may compute it once and pass it to
    the solvers as ``need_table`` (``np.tile`` over the block axis)."""
    Sn, N, L, _ = C.shape
    probe = min(1, N - 1)  # k=2 slice when available
    feas = np.isfinite(C[:, probe])  # (S, L, L): [j-1, b-1]
    need = np.full((Sn, L + 2), INF)
    need[:, L + 1] = 0.0
    rows = np.arange(Sn)
    for j in range(L, 0, -1):
        row = feas[:, j - 1, :]  # (S, L), feasibility of [j..b]
        any_feas = row.any(axis=1)
        b_max = L - 1 - np.argmax(row[:, ::-1], axis=1)  # 0-indexed; junk if none
        greedy_next = need[rows, np.clip(b_max + 2, 0, L + 1)]
        greedy_ok = any_feas & np.isfinite(greedy_next)
        # fallback: scan all feasible extents b in [j, L]
        nxt = need[:, j + 1 : L + 2]  # (S, L-j+1), need[b+1] for b=j..L
        ext = np.where(row[:, j - 1 :] & np.isfinite(nxt), 1.0 + nxt, INF)
        fb = ext.min(axis=1)
        need[:, j] = np.where(greedy_ok, 1.0 + greedy_next, fb)
    return need


# ---------------------------------------------------------------------------
# Batched Algorithm 2 — Greedy
# ---------------------------------------------------------------------------


def batched_greedy_search(
    C: np.ndarray,
    combine: str = "sum",
    feasibility_lookahead: bool = True,
    n_devices: np.ndarray | Sequence[int] | int | None = None,
    need_table: np.ndarray | None = None,
) -> BatchedSolverResult:
    """Algorithm 2 vectorized over the scenario axis; semantics-faithful
    to :func:`repro_torch.core.solvers.greedy_search` (same window, lookahead
    pruning, and lowest-index tie-breaking). Bit-identical to the scalar
    greedy — always, including under exact cost ties.

    ``n_devices`` optionally gives each scenario its own fleet size
    (see :func:`_normalize_ns`): a scenario freezes after choosing its
    ``n_s - 1`` splits while larger fleets keep extending, so mixed
    fleet sizes batch in one pass. ``need_table`` optionally supplies a
    precomputed :func:`_min_devices_suffix_batched` result (see its
    docstring; advanced callers that tile a base tensor)."""
    Sn, N, L, _ = C.shape
    t0 = time.perf_counter()
    ns = _normalize_ns(n_devices, Sn, N)
    if not feasibility_lookahead:
        need = None
    else:
        need = need_table if need_table is not None \
            else _min_devices_suffix_batched(C)
    pos = np.zeros(Sn, dtype=np.int64)  # last chosen boundary (0 = start)
    alive = np.ones(Sn, dtype=bool)
    splits = np.full((Sn, max(N - 1, 0)), -1, dtype=np.int64)
    j_idx = np.arange(L)[None, :]
    for k in range(1, N):
        # only scenarios still choosing a k-th split do any work (frozen
        # smaller fleets cost nothing — the folded fleet-size axis does
        # the same array work as per-size passes)
        act = np.flatnonzero(k <= ns - 1)
        if act.size == 0:
            break
        rem = ns[act] - k  # devices left after device k
        row = C[act, k - 1, np.clip(pos[act], 0, L - 1), :]  # (Sa, L)
        mask = j_idx > (L - 1 - rem[:, None])  # nxt > L-(n_s-k)
        if need is not None:
            mask = mask | (need[act, 2:] > rem[:, None])  # need[nxt+1]
        row = np.where(mask, INF, row)
        best = row.min(axis=1)
        nxt = row.argmin(axis=1) + 1  # first minimum = lowest nxt, like scalar
        alive_a = alive[act] & np.isfinite(best)
        alive[act] = alive_a
        splits[act, k - 1] = np.where(alive_a, nxt, -1)
        pos[act] = np.where(alive_a, nxt, pos[act])
    cost = np.where(
        alive,
        _per_scenario_total_cost(C, np.maximum(splits, 1), combine, ns),
        INF,
    )
    feas = np.isfinite(cost)
    return BatchedSolverResult(
        solver="batched_greedy", backend="numpy", n_devices=N,
        splits=splits, cost_s=cost, feasible=feas,
        wall_time_s=time.perf_counter() - t0,
        n_devices_s=None if n_devices is None else ns,
    )


def batched_greedy_search_all_k(
    C: np.ndarray,
    combine: str = "sum",
    feasibility_lookahead: bool = True,
    fleet_sizes: Sequence[int] | None = None,
) -> dict[int, BatchedSolverResult]:
    """Greedy-solve every fleet size in ONE batched pass: ``{n: result}``.

    Same block construction as :func:`batched_beam_search_all_k` (fleet
    sizes as a leading block axis over the SHARED base tensor, active
    blocks a descending prefix, one suffix-packability table); each
    result is element-wise identical to
    ``batched_greedy_search(C[:, :n])`` — and therefore bit-identical
    to the scalar greedy."""
    Sn, N, L, _ = C.shape
    sizes = tuple(fleet_sizes) if fleet_sizes is not None else tuple(range(1, N + 1))
    if len(set(sizes)) != len(sizes):
        raise ValueError(f"fleet_sizes has duplicates: {sizes}")
    for n in sizes:
        if not 1 <= n <= N:
            raise ValueError(f"fleet size {n} out of range [1, {N}]")
    t0 = time.perf_counter()
    need = _min_devices_suffix_batched(C) if feasibility_lookahead else None
    desc = tuple(sorted(sizes, reverse=True))
    B = len(desc)
    n_max = desc[0]
    sz = np.asarray(desc, dtype=np.int64)

    pos = np.zeros((B, Sn), dtype=np.int64)
    alive = np.ones((B, Sn), dtype=bool)
    splits = np.full((B, Sn, max(n_max - 1, 0)), -1, dtype=np.int64)
    j_idx = np.arange(L)[None, None, :]
    for k in range(1, n_max):
        nb = int((sz - 1 >= k).sum())  # blocks still choosing a k-th split
        if nb == 0:
            break
        rem = (sz[:nb] - k)[:, None, None]
        Ck = C[:, k - 1]  # (Sn, L, L) view shared by every block
        row = np.take_along_axis(
            Ck[None], np.clip(pos[:nb], 0, L - 1)[:, :, None, None],
            axis=2)[:, :, 0, :]  # (nb, Sn, L)
        mask = j_idx > (L - 1 - rem)
        if need is not None:
            mask = mask | (need[None, :, 2:] > rem)
        row = np.where(mask, INF, row)
        best = row.min(axis=2)
        nxt = row.argmin(axis=2) + 1  # first minimum = lowest nxt
        alive_a = alive[:nb] & np.isfinite(best)
        alive[:nb] = alive_a
        splits[:nb, :, k - 1] = np.where(alive_a, nxt, -1)
        pos[:nb] = np.where(alive_a, nxt, pos[:nb])

    out: dict[int, BatchedSolverResult] = {}
    for b, n in enumerate(desc):
        spl = splits[b, :, : max(n - 1, 0)].copy()
        cost = np.where(
            alive[b],
            _per_scenario_total_cost(C[:, :n], np.maximum(spl, 1), combine),
            INF,
        )
        feas = np.isfinite(cost)
        out[n] = BatchedSolverResult(
            solver="batched_greedy", backend="numpy", n_devices=n,
            splits=spl, cost_s=cost, feasible=feas, wall_time_s=0.0,
        )
    # one shared family wall, stamped after cost extraction (the
    # BatchedSolverResult timing-scope contract)
    wall = time.perf_counter() - t0
    return {n: replace(out[n], wall_time_s=wall) for n in sizes}


# ---------------------------------------------------------------------------
# Batched Algorithm 1 — Beam Search
# ---------------------------------------------------------------------------


def batched_beam_search(
    C: np.ndarray,
    beam_width: int = 8,
    combine: str = "sum",
    feasibility_lookahead: bool = True,
    n_devices: np.ndarray | Sequence[int] | int | None = None,
    need_table: np.ndarray | None = None,
) -> BatchedSolverResult:
    """Algorithm 1 vectorized over the scenario axis.

    Faithful to :func:`repro_torch.core.solvers.beam_search`: the same
    admissible completion bound ranks candidates before truncation, the
    same per-position dominance collapses ties (first-seen beam order
    wins), and the suffix-packability lookahead prunes dead ends. On
    instances without exact floating-point cost ties it returns
    bit-identical splits to the scalar solver; under exact ties the
    truncation order differs (landing-position vs generation order) and
    either beam may keep the luckier candidate — only ``batched_dp``
    carries an unconditional bit-parity guarantee.

    ``n_devices`` optionally gives each scenario its own fleet size
    (see :func:`_normalize_ns`). Scenario ``s`` pins its final segment
    to end at ``L`` on its own last device ``n_s`` and freezes while
    larger fleets keep extending — every per-scenario window, lookahead
    threshold, and completion bound uses ``n_s``, so each scenario's
    beam evolves exactly as a standalone ``n_s``-device solve.
    ``need_table``: optional precomputed
    :func:`_min_devices_suffix_batched` result (see its docstring)."""
    Sn, N, L, _ = C.shape
    t0 = time.perf_counter()
    comb = _combine_ufunc(combine)
    if not feasibility_lookahead:
        need = None
    else:
        need = need_table if need_table is not None \
            else _min_devices_suffix_batched(C)
    W = beam_width
    rows = np.arange(Sn)
    ns = _normalize_ns(n_devices, Sn, N)

    # beam state: slot arrays ordered by the scalar solver's ranking
    cost = np.full((Sn, 1), 0.0)
    pos = np.zeros((Sn, 1), dtype=np.int64)
    hist = np.full((Sn, 1, N), -1, dtype=np.int64)  # chosen boundaries per slot

    for k in range(1, N + 1):
        # scenarios whose fleet already completed (k > n_s) are frozen:
        # each step processes only the still-active row subset, so a
        # folded fleet-size axis costs the same array work as per-size
        # passes (row s runs exactly n_s steps)
        act = np.flatnonzero(ns >= k)
        if act.size == 0:
            break
        full = act.size == Sn
        nsa = ns if full else ns[act]
        costa = cost if full else cost[act]
        posa = pos if full else pos[act]
        Sa = act.size
        rem = nsa - k  # devices left after device k; 0 = finishing
        finishing = rem == 0
        fin3 = finishing[:, None, None]
        # extension costs E[s, w, j]: segment (pos+1 .. j+1) on device k
        Ck = C[:, k - 1] if full else C[act, k - 1]  # (Sa, L, L)
        seg = np.take_along_axis(Ck, np.clip(posa, 0, L - 1)[:, :, None],
                                 axis=1)
        E = comb(costa[:, :, None], seg)  # (Sa, w, L)
        E = np.where(np.isfinite(costa)[:, :, None], E, INF)
        j_idx = np.arange(L)[None, None, :]
        # k == n_s: s_N = L pinned; k < n_s: window + lookahead pruning
        E = np.where(fin3 & (j_idx != L - 1), INF, E)
        E = np.where(~fin3 & (j_idx > L - 1 - rem[:, None, None]), INF, E)
        if need is not None:
            needa = need if full else need[act]
            E = np.where(~fin3 & (needa[:, None, 2:] > rem[:, None, None]),
                         INF, E)
        # dominance: best slot per landing position (ties -> lowest slot,
        # i.e. scalar generation order)
        D = E.min(axis=1)  # (Sa, L)
        back = E.argmin(axis=1)  # (Sa, L)
        # ranking: admissible completion bound (scalar's truncation key).
        # scalar's completion_bound(nxt, k): the whole suffix [nxt+1..L]
        # as ONE segment on device min(k+1, n_s) lower-bounds any further
        # segmentation (superadditive costs); INF -> 0 (feasibility is
        # the lookahead's job). Candidate j lands at boundary nxt=j+1,
        # so its suffix starts at layer j+2 -> start index j+1.
        whole = C[act, np.minimum(k, nsa - 1), :, L - 1]  # (Sa, L) by start-1
        bound = np.where(np.isfinite(whole), whole, 0.0)
        bshift = np.concatenate([bound[:, 1:], np.zeros((Sa, 1))], axis=1)
        bshift[:, L - 1] = 0.0  # nxt = L: empty suffix
        if combine == "max":
            mid = np.maximum(D, bshift / np.maximum(rem, 1)[:, None])
        else:
            mid = D + bshift
        key = np.where(finishing[:, None], D,
                       np.where(np.isfinite(D), mid, INF))
        order = np.argsort(key, axis=1, kind="stable")[:, :W]  # (Sa, <=W)
        new_cost = np.take_along_axis(D, order, axis=1)
        new_pos = order + 1  # boundary after layer j+1 (1-indexed)
        slot = np.take_along_axis(back, order, axis=1)  # predecessor slot
        hista = hist[act[:, None], slot]  # (Sa, W', N)
        hista[:, :, k - 1] = np.where(np.isfinite(new_cost), new_pos, -1)
        dead = ~np.isfinite(new_cost)
        new_cost = np.where(dead, INF, new_cost)
        new_pos = np.where(dead, 0, new_pos)
        if k == 1:
            # slot count grows 1 -> min(W, L) this step; every scenario
            # is active at its first device, so adopt directly
            cost, pos, hist = new_cost, new_pos, hista
        else:
            cost[act] = new_cost
            pos[act] = new_pos
            hist[act] = hista

    best_cost = cost[:, 0]
    feas = np.isfinite(best_cost)
    width_ok = np.arange(max(N - 1, 0))[None, :] < (ns[:, None] - 1)
    splits = np.where(feas[:, None] & width_ok, hist[:, 0, : N - 1], -1)
    return BatchedSolverResult(
        solver="batched_beam", backend="numpy", n_devices=N,
        splits=splits, cost_s=np.where(feas, best_cost, INF),
        feasible=feas, wall_time_s=time.perf_counter() - t0,
        n_devices_s=None if n_devices is None else ns,
    )


def batched_beam_search_all_k(
    C: np.ndarray,
    beam_width: int = 8,
    combine: str = "sum",
    feasibility_lookahead: bool = True,
    fleet_sizes: Sequence[int] | None = None,
) -> dict[int, BatchedSolverResult]:
    """Beam-solve every fleet size in ONE batched pass: ``{n: result}``.

    The all-k counterpart of ``batched_optimal_dp(return_all_k=True)``
    for Algorithm 1 (including the bottleneck objective). Unlike the
    DP — whose table at device ``k`` *is* the ``k``-device answer —
    beams for different fleet sizes genuinely diverge (the truncation
    key, window, and lookahead all depend on the devices remaining), so
    sharing one beam would break bit-parity with the per-``k`` solver.
    Instead the fleet-size axis is folded into the scenario axis: the
    tensor is viewed once per requested size and a single vectorized
    recursion solves all of them, with no per-``N`` Python re-solve
    loop. Each returned result is element-wise identical (``==`` on
    splits, cost, feasibility) to ``batched_beam_search(C[:, :n])``.

    ``fleet_sizes`` defaults to every ``n = 1..N``; pass a subset to
    solve only those.

    Implementation: fleet sizes become a leading *block* axis over the
    SAME base tensor (descending, so the still-active blocks at step
    ``k`` are a contiguous prefix) — no ``len(fleet_sizes)``-fold
    tensor copy, one shared suffix-packability table, and per-step
    work proportional to the blocks still extending."""
    Sn, N, L, _ = C.shape
    sizes = tuple(fleet_sizes) if fleet_sizes is not None else tuple(range(1, N + 1))
    if len(set(sizes)) != len(sizes):
        raise ValueError(f"fleet_sizes has duplicates: {sizes}")
    for n in sizes:
        if not 1 <= n <= N:
            raise ValueError(f"fleet size {n} out of range [1, {N}]")
    t0 = time.perf_counter()
    comb = _combine_ufunc(combine)
    need = _min_devices_suffix_batched(C) if feasibility_lookahead else None
    W = beam_width
    desc = tuple(sorted(sizes, reverse=True))  # active blocks = prefix
    B = len(desc)
    n_max = desc[0]
    sz = np.asarray(desc, dtype=np.int64)

    # block-major beam state: [b, s, w(, boundary)]
    cost = np.full((B, Sn, 1), 0.0)
    pos = np.zeros((B, Sn, 1), dtype=np.int64)
    hist = np.full((B, Sn, 1, n_max), -1, dtype=np.int64)

    for k in range(1, n_max + 1):
        nb = int((sz >= k).sum())  # active blocks: a prefix (descending)
        if nb == 0:
            break
        rem = (sz[:nb] - k)[:, None, None, None]  # 0 = finishing block
        fin4 = rem == 0
        costa = cost[:nb]
        Ck = C[:, k - 1]  # (Sn, L, L) view shared by every block
        seg = np.take_along_axis(
            Ck[None], np.clip(pos[:nb], 0, L - 1)[:, :, :, None], axis=2)
        E = comb(costa[:, :, :, None], seg)  # (nb, Sn, w, L)
        E = np.where(np.isfinite(costa)[:, :, :, None], E, INF)
        j_idx = np.arange(L)[None, None, None, :]
        # k == n: s_N = L pinned; k < n: window + lookahead pruning
        E = np.where(fin4 & (j_idx != L - 1), INF, E)
        E = np.where(~fin4 & (j_idx > L - 1 - rem), INF, E)
        if need is not None:
            E = np.where(~fin4 & (need[None, :, None, 2:] > rem), INF, E)
        # dominance: best slot per landing position (ties -> lowest slot)
        D = E.min(axis=2)  # (nb, Sn, L)
        back = E.argmin(axis=2)
        # ranking: admissible completion bound, per block (suffix device
        # min(k+1, n) differs across fleet sizes)
        whole = np.stack([C[:, min(k, n - 1), :, L - 1]
                          for n in desc[:nb]])  # (nb, Sn, L)
        bound = np.where(np.isfinite(whole), whole, 0.0)
        bshift = np.concatenate(
            [bound[:, :, 1:], np.zeros((nb, Sn, 1))], axis=2)
        bshift[:, :, L - 1] = 0.0  # nxt = L: empty suffix
        rem3 = rem[:, :, :, 0]
        if combine == "max":
            mid = np.maximum(D, bshift / np.maximum(rem3, 1))
        else:
            mid = D + bshift
        key = np.where(fin4[:, :, :, 0], D,
                       np.where(np.isfinite(D), mid, INF))
        order = np.argsort(key, axis=2, kind="stable")[:, :, :W]
        new_cost = np.take_along_axis(D, order, axis=2)
        new_pos = order + 1
        slot = np.take_along_axis(back, order, axis=2)
        new_hist = np.take_along_axis(hist[:nb], slot[:, :, :, None], axis=2)
        new_hist[:, :, :, k - 1] = np.where(np.isfinite(new_cost),
                                            new_pos, -1)
        dead = ~np.isfinite(new_cost)
        new_cost = np.where(dead, INF, new_cost)
        new_pos = np.where(dead, 0, new_pos)
        if k == 1:
            cost, pos, hist = new_cost, new_pos, new_hist
        else:
            cost[:nb] = new_cost
            pos[:nb] = new_pos
            hist[:nb] = new_hist

    out: dict[int, BatchedSolverResult] = {}
    for b, n in enumerate(desc):
        best_cost = cost[b, :, 0].copy()
        feas = np.isfinite(best_cost)
        splits = np.where(feas[:, None], hist[b, :, 0, : n - 1], -1)
        out[n] = BatchedSolverResult(
            solver="batched_beam", backend="numpy", n_devices=n,
            splits=splits, cost_s=np.where(feas, best_cost, INF),
            feasible=feas, wall_time_s=0.0,
        )
    # one shared family wall, stamped after reconstruction (the
    # BatchedSolverResult timing-scope contract)
    wall = time.perf_counter() - t0
    return {n: replace(out[n], wall_time_s=wall) for n in sizes}


BATCHED_SOLVERS: dict[str, Callable[..., BatchedSolverResult]] = {
    "batched_dp": batched_optimal_dp,
    "batched_beam": batched_beam_search,
    "batched_greedy": batched_greedy_search,
}


def _resolve_backend(solver: str, backend: str | None) -> str:
    """The backend a batched solve runs on. ``None`` means ``"cuda"`` for
    ``batched_dp`` and ``"numpy"`` for the host heuristics, which refuse
    any other backend (the reference's rule); a DP backend must be a
    :data:`DP_BACKENDS` key."""
    if solver not in BATCHED_SOLVERS:
        raise ValueError(f"unknown batched solver {solver!r}; "
                         f"options: {sorted(BATCHED_SOLVERS)}")
    if solver == "batched_dp":
        backend = "cuda" if backend is None else backend
        _check_backend(backend)
        return backend
    if backend is None:
        return "numpy"
    if backend != "numpy":
        raise ValueError(f"{solver} supports backend='numpy' only "
                         f"(got {backend!r})")
    return backend


def _refuse_mesh(mesh_spec) -> None:
    if mesh_spec is not None:
        raise ValueError("mesh_spec is a backend='sharded' knob; 'sharded' "
                         "is not ported")


def solve_batched(
    C: np.ndarray,
    solver: str = "batched_dp",
    combine: str = "sum",
    backend: str | None = None,
    n_devices: np.ndarray | Sequence[int] | int | None = None,
    mesh_spec=None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
    **solver_kwargs,
) -> BatchedSolverResult:
    """The single dispatch point for batched solves over a stacked tensor
    (used by :func:`sweep`, ``planner.plan_split_batch`` and the surface
    builder). ``n_devices`` (optional per-scenario fleet sizes) is
    threaded to every solver; ``device`` / ``dtype`` reach the DP's
    ``"cuda"`` and ``"torch"`` backends.

    In the reference this is a shim over the planner tier; the port has no
    planner tier yet, so it calls :func:`_solve_batched_impl` directly."""
    return _solve_batched_impl(C, solver=solver, combine=combine,
                               backend=backend, n_devices=n_devices,
                               mesh_spec=mesh_spec, device=device,
                               dtype=dtype, **solver_kwargs)


def _solve_batched_impl(
    C: np.ndarray,
    solver: str = "batched_dp",
    combine: str = "sum",
    backend: str | None = None,
    n_devices: np.ndarray | Sequence[int] | int | None = None,
    mesh_spec=None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
    **solver_kwargs,
) -> BatchedSolverResult:
    """The dispatch body behind :func:`solve_batched`."""
    backend = _resolve_backend(solver, backend)
    _refuse_mesh(mesh_spec)
    if solver == "batched_dp":
        return batched_optimal_dp(C, combine=combine, backend=backend,
                                  n_devices=n_devices, device=device,
                                  dtype=dtype, **solver_kwargs)
    fn = batched_beam_search if solver == "batched_beam" else batched_greedy_search
    return fn(C, combine=combine, n_devices=n_devices, **solver_kwargs)


# batched solver name -> the scalar oracle it must match bit-for-bit
SCALAR_ORACLES: dict[str, str] = {
    "batched_dp": "optimal_dp",
    "batched_beam": "beam",
    "batched_greedy": "greedy",
}


# ---------------------------------------------------------------------------
# Multi-channel solves (latency + energy; budgets and weighted combines)
# ---------------------------------------------------------------------------


def apply_energy_budget(
    C: np.ndarray,
    E: np.ndarray,
    energy_budget: float | np.ndarray | Sequence[float] | None,
) -> np.ndarray:
    """Mask the latency tensor ``C`` to +inf wherever the matching energy
    tensor ``E`` exceeds the per-device ``energy_budget``.

    Every device executes exactly one segment, so a per-device Joule
    budget is a per-segment constraint: the masked tensor is an ordinary
    ``(S, N, L, L)`` cost tensor every backend solves unchanged.
    ``None`` or +inf means unconstrained (``C`` is returned untouched);
    a scalar applies to every scenario; an ``(S,)`` vector gives each
    scenario its own budget. The comparison is the strict ``E > budget``
    of the scalar :func:`repro_torch.core.solvers.budget_masked`."""
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


def combine_channels(
    C: np.ndarray, weights: Sequence[float]
) -> np.ndarray:
    """Scalarize a stacked multi-channel tensor ``C[ch, ...]`` into one
    cost tensor ``sum_ch weights[ch] * C[ch]`` (weighted latency×energy
    combine). Entries where ANY channel is non-finite scalarize to +inf
    (a zero weight must not resurrect an infeasible segment via
    ``0 * inf``)."""
    w = np.asarray(weights, dtype=np.float64)
    if w.ndim != 1 or w.shape[0] != C.shape[0]:
        raise ValueError(f"weights must have one entry per channel "
                         f"({C.shape[0]}), got shape {w.shape}")
    finite = np.isfinite(C).all(axis=0)
    with np.errstate(invalid="ignore"):
        eff = np.tensordot(w, np.where(np.isfinite(C), C, 0.0), axes=1)
    return np.where(finite, eff, INF)


def solve_multi_channel(
    C: np.ndarray,
    channels: Sequence[str] = COST_CHANNELS,
    solver: str = "batched_dp",
    combine: str = "sum",
    backend: str | None = None,
    n_devices: np.ndarray | Sequence[int] | int | None = None,
    energy_budget: float | np.ndarray | Sequence[float] | None = None,
    channel_weights: Sequence[float] | None = None,
    channel_combines: Sequence[str] | None = None,
    mesh_spec=None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
    **solver_kwargs,
) -> BatchedSolverResult:
    """Multi-objective batched solve over ``C[ch, s, k-1, a-1, b-1]``. In
    the reference a shim over the planner tier; here it calls
    :func:`_solve_multi_channel_impl` directly. See the impl."""
    return _solve_multi_channel_impl(
        C, channels=channels, solver=solver, combine=combine,
        backend=backend, n_devices=n_devices, energy_budget=energy_budget,
        channel_weights=channel_weights, channel_combines=channel_combines,
        mesh_spec=mesh_spec, device=device, dtype=dtype, **solver_kwargs)


def _solve_multi_channel_impl(
    C: np.ndarray,
    channels: Sequence[str] = COST_CHANNELS,
    solver: str = "batched_dp",
    combine: str = "sum",
    backend: str | None = None,
    n_devices: np.ndarray | Sequence[int] | int | None = None,
    energy_budget: float | np.ndarray | Sequence[float] | None = None,
    channel_weights: Sequence[float] | None = None,
    channel_combines: Sequence[str] | None = None,
    mesh_spec=None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
    **solver_kwargs,
) -> BatchedSolverResult:
    """Multi-objective batched solve over a stacked channel tensor
    ``C[ch, s, k-1, a-1, b-1]`` (see :func:`stack_cost_tensors` with
    ``channels=``).

    Modes (composable):
      * **degenerate** — one channel, no budget, no weights: solves
        ``C[0]`` untouched through :func:`solve_batched`, bit-exact vs
        the single-channel path on every backend;
      * **budget** — ``energy_budget`` masks the latency channel to +inf
        wherever the ``"energy"`` channel exceeds the per-device budget
        (:func:`apply_energy_budget`), then minimizes latency;
      * **weighted** — ``channel_weights`` scalarizes the channels
        (:func:`combine_channels`) before the solve; may be combined
        with ``energy_budget`` (the mask applies after scalarization).

    ``channel_combines`` gives each channel its own combine for the
    reported per-channel totals (default: the solve's ``combine`` for
    latency, ``"sum"`` for energy). ``channel_cost_s[ch, s]`` is channel
    ``ch``'s total for the CHOSEN plan."""
    C = np.asarray(C, dtype=np.float64)
    if C.ndim != 5:
        raise ValueError(f"C must be (n_channels, S, N, L, L), got {C.shape}")
    channels = tuple(channels)
    if C.shape[0] != len(channels):
        raise ValueError(f"C has {C.shape[0]} channel slices for "
                         f"{len(channels)} channel names {channels!r}")
    if solver_kwargs.get("return_all_k"):
        raise ValueError("solve_multi_channel does not support return_all_k")
    if len(channels) == 1 and energy_budget is None and channel_weights is None:
        return solve_batched(C[0], solver=solver, combine=combine,
                             backend=backend, n_devices=n_devices,
                             mesh_spec=mesh_spec, device=device, dtype=dtype,
                             **solver_kwargs)
    try:
        lat = channels.index("latency")
    except ValueError:
        raise ValueError(f"channels {channels!r} lack a 'latency' entry") \
            from None
    if channel_weights is not None:
        C_eff = combine_channels(C, channel_weights)
    else:
        C_eff = C[lat]
    if energy_budget is not None:
        try:
            en = channels.index("energy")
        except ValueError:
            raise ValueError(f"energy_budget given but channels {channels!r} "
                             f"lack an 'energy' entry") from None
        C_eff = apply_energy_budget(C_eff, C[en], energy_budget)
    res = solve_batched(C_eff, solver=solver, combine=combine,
                        backend=backend, n_devices=n_devices,
                        mesh_spec=mesh_spec, device=device, dtype=dtype,
                        **solver_kwargs)
    if channel_combines is None:
        channel_combines = tuple(
            combine if ch == "latency" else "sum" for ch in channels)
    safe_splits = np.maximum(res.splits, 1)
    per_ch = np.stack([
        np.where(res.feasible,
                 _per_scenario_total_cost(C[i], safe_splits, cmb,
                                          res.n_devices_s),
                 INF)
        for i, cmb in enumerate(channel_combines)
    ])
    return replace(res, channels=channels, channel_cost_s=per_ch)


# ---------------------------------------------------------------------------
# Variant-bank solves (joint split × bottleneck-variant decisions)
# ---------------------------------------------------------------------------


def apply_accuracy_floor(
    C: np.ndarray,
    accuracy_proxy: np.ndarray | Sequence[float] | None,
    accuracy_floor: float | None,
) -> np.ndarray:
    """Mask whole variant slices of a stacked variant tensor
    ``C[v, s, k-1, a-1, b-1]`` to +inf wherever the variant's
    ``accuracy_proxy`` falls below ``accuracy_floor``.

    This is the accuracy-constrained planning mode — ``min latency
    s.t. accuracy_proxy >= floor`` — expressed exactly like
    :func:`apply_energy_budget`: the constraint becomes +inf entries in
    an ordinary cost tensor every existing backend solves unchanged.
    ``accuracy_floor=None`` means unconstrained (``C`` is returned
    untouched — the identical object, keeping the degenerate path
    bit-exact); the comparison is the same strict inequality the scalar
    :func:`repro_torch.core.solvers._best_variant` dispatcher uses
    (``accuracy_proxy < floor`` masks)."""
    if accuracy_floor is None:
        return C
    if accuracy_proxy is None:
        raise ValueError("accuracy_floor given without accuracy_proxy")
    acc = np.asarray(accuracy_proxy, dtype=np.float64)
    if acc.ndim != 1 or acc.shape[0] != C.shape[0]:
        raise ValueError(
            f"accuracy_proxy must have one entry per variant "
            f"({C.shape[0]},); got shape {acc.shape}")
    mask = acc < float(accuracy_floor)
    if not mask.any():
        return C
    return np.where(mask[:, None, None, None, None], INF, C)


def _fold_variant_axis(
    res: BatchedSolverResult, V: int, Sn: int
) -> tuple[BatchedSolverResult, np.ndarray]:
    """Collapse a variant-major folded solve (``V*Sn`` scenarios, index
    ``v*Sn + s``) back to ``Sn`` scenarios: per-scenario argmin over the
    ``V`` stacked costs. ``np.argmin`` keeps the FIRST minimum — the
    lowest variant index on exact ties, matching the scalar
    ``_best_variant`` strict-``<`` loop. Returns the folded result
    (``variant`` set, -1 where infeasible) and the winning row indices
    into the folded scenario axis (callers gather per-node data — e.g.
    the winning variant's cost-tensor rows — with them)."""
    cost_vs = res.cost_s.reshape(V, Sn)
    v_star = np.argmin(cost_vs, axis=0)
    s_idx = np.arange(Sn)
    rows = v_star * Sn + s_idx
    feasible = res.feasible[rows]
    variant = np.where(feasible, v_star, -1).astype(np.int64)
    folded = BatchedSolverResult(
        solver=res.solver,
        backend=res.backend,
        n_devices=res.n_devices,
        splits=res.splits[rows],
        cost_s=cost_vs[v_star, s_idx],
        feasible=feasible,
        wall_time_s=res.wall_time_s,
        n_devices_s=(None if res.n_devices_s is None
                     else res.n_devices_s[rows]),
        variant=variant,
    )
    return folded, rows


def solve_variant_bank(
    C: np.ndarray,
    solver: str = "batched_dp",
    combine: str = "sum",
    backend: str | None = None,
    n_devices: np.ndarray | Sequence[int] | int | None = None,
    accuracy_proxy: np.ndarray | Sequence[float] | None = None,
    accuracy_floor: float | None = None,
    mesh_spec=None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
    **solver_kwargs,
) -> BatchedSolverResult:
    """Joint (split point, bottleneck variant) solve over
    ``C[v, s, k-1, a-1, b-1]``. In the reference a shim over the planner
    tier; here it calls :func:`_solve_variant_bank_impl` directly. See the
    impl."""
    return _solve_variant_bank_impl(
        C, solver=solver, combine=combine, backend=backend,
        n_devices=n_devices, accuracy_proxy=accuracy_proxy,
        accuracy_floor=accuracy_floor, mesh_spec=mesh_spec, device=device,
        dtype=dtype, **solver_kwargs)


def _solve_variant_bank_impl(
    C: np.ndarray,
    solver: str = "batched_dp",
    combine: str = "sum",
    backend: str | None = None,
    n_devices: np.ndarray | Sequence[int] | int | None = None,
    accuracy_proxy: np.ndarray | Sequence[float] | None = None,
    accuracy_floor: float | None = None,
    mesh_spec=None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
    **solver_kwargs,
) -> BatchedSolverResult:
    """Jointly optimize ``(split point, bottleneck variant)`` over a
    stacked variant tensor ``C[v, s, k-1, a-1, b-1]`` (see
    :func:`stack_cost_tensors` with ``variants=``).

    The variant axis folds into the scenario axis (variant-major, index
    ``v * S + s``) and ONE batched solve prices every (variant, scenario)
    pair; the per-scenario winner is the argmin over the ``V`` costs,
    the lowest variant index on exact ties (the scalar
    :func:`repro_torch.core.solvers._best_variant` tie-break). ``V == 1``
    solves ``C[0]`` untouched. ``accuracy_proxy`` + ``accuracy_floor``
    mask below-floor variants (:func:`apply_accuracy_floor`). The
    result's ``variant[s]`` is the winning bank index (-1 where no
    variant is feasible)."""
    C = np.asarray(C, dtype=np.float64)
    if C.ndim != 5:
        raise ValueError(f"C must be (n_variants, S, N, L, L), got {C.shape}")
    if solver_kwargs.get("return_all_k"):
        raise ValueError("solve_variant_bank does not support return_all_k")
    V, Sn, N, L, _ = C.shape
    acc = None
    if accuracy_proxy is not None:
        acc = np.asarray(accuracy_proxy, dtype=np.float64)
    C = apply_accuracy_floor(C, acc, accuracy_floor)
    if V == 1:
        res = solve_batched(C[0], solver=solver, combine=combine,
                            backend=backend, n_devices=n_devices,
                            mesh_spec=mesh_spec, device=device, dtype=dtype,
                            **solver_kwargs)
        variant = np.where(res.feasible, 0, -1).astype(np.int64)
        return replace(res, variant=variant)
    ns = _normalize_ns(n_devices, Sn, N) if n_devices is not None else None
    folded_ns = None if ns is None else np.tile(ns, V)
    res = solve_batched(C.reshape(V * Sn, N, L, L), solver=solver,
                        combine=combine, backend=backend,
                        n_devices=folded_ns, mesh_spec=mesh_spec,
                        device=device, dtype=dtype, **solver_kwargs)
    folded, _ = _fold_variant_axis(res, V, Sn)
    return folded


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

    def degradation_surface(self, model: str | None = None,
                            n_devices: int | None = None,
                            mix: str | None = None, **kwargs):
        """Precompute a :class:`~repro_torch.core.surface.DegradationSurface`
        whose packet-time/loss axes derive from this grid's
        ``rate_scale``/``loss_p`` axes (the sweep's link what-ifs become
        the runtime's O(1) replanning lookup table). ``n_devices``
        defaults to the grid's largest fleet size; ``mix`` selects a
        device mix (see :meth:`devices_for` semantics)."""
        from repro_torch.core.surface import DegradationSurface  # lazy: no cycle

        return DegradationSurface.from_scenario_grid(
            self, model=model, n_devices=n_devices, mix=mix, **kwargs)

    def degradation_surfaces(self, model: str | None = None,
                             n_devices: Sequence[int] | None = None,
                             mix: str | None = None, **kwargs):
        """Precompute surfaces for SEVERAL fleet sizes — one per entry
        of ``n_devices`` (default: this grid's whole ``n_devices``
        axis) — in ONE batched solver pass (no per-N re-solve loop; see
        :func:`repro_torch.core.surface.build_surfaces`). Returns
        ``{n: DegradationSurface}``."""
        from repro_torch.core import surface as SF  # lazy: no cycle

        cost_model, pt_scales, losses = SF._grid_surface_args(self, model, mix)
        sizes = tuple(n_devices) if n_devices is not None else self.n_devices
        return SF.build_surfaces(
            cost_model, self.links, sizes,
            pt_scale=pt_scales, loss_p=losses, **kwargs)


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

    def to_csv(self) -> str:
        cols = ["model", "protocol", "n_devices", "loss_p", "rate_scale",
                "mix", "contention", "energy_budget", "compression",
                "feasible", "splits", "objective_cost_s", "total_latency_s",
                "accuracy_proxy", "device_s", "transmission_s",
                "solver_wall_s"]
        lines = [",".join(cols)]
        for d in self.to_dicts():
            d["splits"] = "|".join(str(x) for x in d["splits"])
            lines.append(",".join(str(d[c]) for c in cols))
        return "\n".join(lines) + "\n"

    def pareto(
        self, by: Sequence[str] = ("model", "protocol", "n_devices")
    ) -> dict[tuple, "ParetoFrontier"]:
        """Latency-vs-accuracy Pareto frontiers, one per distinct value
        of the ``by`` scenario fields (default: per model × protocol ×
        fleet size). Within each group the non-dominated set over
        ``(total_latency_s, accuracy_proxy)`` is extracted by
        :func:`pareto_frontier`; rows differing only in compression
        factor (and any other swept axes not named in ``by``) compete
        in the same frontier."""
        by = tuple(by)
        groups: dict[tuple, list[SweepRow]] = {}
        for r in self.rows:
            key = tuple(getattr(r.scenario, k) for k in by)
            groups.setdefault(key, []).append(r)
        return {key: ParetoFrontier(by=by, key=key, rows=pareto_frontier(g))
                for key, g in groups.items()}


def pareto_frontier(rows: Sequence[SweepRow]) -> tuple[SweepRow, ...]:
    """The non-dominated subset of ``rows`` under minimize
    ``total_latency_s`` / maximize ``accuracy_proxy``.

    Row ``r`` is dominated iff some other row has latency <= and
    accuracy >= with at least one strict inequality; exact duplicates
    on both axes all survive (neither dominates the other). Infeasible
    rows never enter the frontier. The extraction is the O(n^2)
    pairwise definition verbatim — frontier sizes are small and the
    semantics stay visibly identical to the brute-force oracle the
    property suite compares against. Result is sorted by ascending
    latency (descending accuracy on ties)."""
    feas = [r for r in rows if r.feasible]
    front = []
    for r in feas:
        dominated = False
        for o in feas:
            if (o.total_latency_s <= r.total_latency_s
                    and o.accuracy_proxy >= r.accuracy_proxy
                    and (o.total_latency_s < r.total_latency_s
                         or o.accuracy_proxy > r.accuracy_proxy)):
                dominated = True
                break
        if not dominated:
            front.append(r)
    front.sort(key=lambda r: (r.total_latency_s, -r.accuracy_proxy))
    return tuple(front)


@dataclass(frozen=True)
class ParetoFrontier:
    """One group's latency-vs-accuracy frontier (see
    :meth:`SweepResult.pareto`): the non-dominated rows, sorted by
    ascending latency."""

    by: tuple[str, ...]  # the scenario fields the group was keyed on
    key: tuple  # this group's values for those fields
    rows: tuple[SweepRow, ...]  # non-dominated, ascending latency

    @property
    def n_points(self) -> int:
        return len(self.rows)

    def to_csv(self) -> str:
        cols = list(self.by) + ["compression", "accuracy_proxy",
                                "total_latency_s", "splits"]
        lines = [",".join(cols)]
        for r in self.rows:
            vals = [str(getattr(r.scenario, k)) for k in self.by]
            vals += [str(r.scenario.compression), str(r.accuracy_proxy),
                     str(r.total_latency_s),
                     "|".join(str(x) for x in r.splits)]
            lines.append(",".join(vals))
        return "\n".join(lines) + "\n"


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
    backend: str | None = None,
    beam_width: int = 8,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> SweepResult:
    """Plan every scenario of ``grid`` in batched passes.

    Args:
      grid: the scenario grid to price.
      solver: one of :data:`BATCHED_SOLVERS` (``batched_dp`` /
        ``batched_beam`` / ``batched_greedy``).
      backend: for ``batched_dp``, ``"cuda"`` (the default: the fused
        kernel builds ``C[s,k] = bank[idx] + TX[s]`` inside its
        reduction, ``C`` never materialised; energy-budgeted groups mask
        a materialised ``C`` and run the dense kernel), ``"torch"`` (the
        dense plain version on a materialised ``C``) or ``"numpy"``
        (float64 oracle on the host). Beam and greedy run numpy on the
        host and refuse any other backend.
      beam_width: beam width when ``solver="batched_beam"``.
      device / dtype: see the module docstring.

    Scenarios are grouped by model; within a group every fleet size and
    device mix stacks into one solve (per-device cost matrices come from
    a bank with one entry per distinct ``(DeviceProfile, is_first)``
    pair, smaller fleets ride the per-scenario ``n_devices`` vector).
    Row order equals ``grid.scenarios()`` order."""
    backend = _resolve_backend(solver, backend)
    if backend in ("cuda", "torch"):
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

            kwargs = {"beam_width": beam_width} if solver == "batched_beam" else {}
            res = solve_batched(C, solver=solver, combine=combine,
                                backend=backend, n_devices=ns, device=device,
                                dtype=dtype, **kwargs)
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


def sweep_scalar(grid: ScenarioGrid, solver: str = "optimal_dp") -> SweepResult:
    """The un-batched reference: one scalar solve per scenario (the
    per-scenario Python loop the batched engine replaces). Used as the
    parity oracle in tests and the baseline in benchmark speedup
    reporting. Device mixes flow through :meth:`ScenarioGrid.cost_model`
    (each scenario's :class:`SplitCostModel` carries its own fleet), so
    this loop is also the heterogeneous-fleet oracle."""
    combine = "max" if grid.objective == "bottleneck" else "sum"
    rows = []
    solve_time = 0.0
    build_time = 0.0
    for sc in grid.scenarios():
        t0 = time.perf_counter()
        m = grid.cost_model(sc)
        L = m.profile.num_layers
        fn = m.cost_segment_fn()
        build_time += time.perf_counter() - t0
        kwargs = {}
        if sc.energy_budget is not None:
            # the scalar solvers mask cost_fn by the same strict
            # per-segment comparison the batched path applies to the
            # stacked tensors, so parity holds under budgets too
            kwargs = dict(energy_fn=m.energy_segment_fn(),
                          energy_budget=sc.energy_budget)
        res = S.SOLVERS[solver](fn, L, sc.n_devices, combine=combine, **kwargs)
        solve_time += res.wall_time_s
        feasible = res.feasible
        if feasible:
            link = grid.effective_link(sc)
            bounds = [0, *res.splits, L]
            # cut_cost_s = compressed airtime + encoder time (identical
            # to the bare airtime for identity-variant scenarios)
            tx_total = sum(m.cut_cost_s(b) for b in bounds[1:-1])
            obj = res.cost_s
            seg_sum = S.total_cost(fn, res.splits, L, "sum")
            device_s = seg_sum - tx_total
            rows.append(SweepRow(
                scenario=sc, splits=res.splits, feasible=True,
                objective_cost_s=obj,
                total_latency_s=obj + link.t_setup_s + link.t_feedback_s,
                device_s=device_s, transmission_s=tx_total,
                solver_wall_s=res.wall_time_s,
                accuracy_proxy=grid.accuracy_for(sc),
            ))
        else:
            rows.append(SweepRow(
                scenario=sc, splits=res.splits, feasible=False,
                objective_cost_s=INF, total_latency_s=INF, device_s=INF,
                transmission_s=INF, solver_wall_s=res.wall_time_s,
                accuracy_proxy=grid.accuracy_for(sc),
            ))
    return SweepResult(rows=tuple(rows), solver=solver, backend="scalar",
                       solve_time_s=solve_time, build_time_s=build_time)


def parity_report(batched: SweepResult, scalar: SweepResult) -> list[str]:
    """Human-readable mismatch list between two sweeps of the same grid
    (empty = bit-identical splits everywhere, the acceptance contract)."""
    if batched.n_scenarios != scalar.n_scenarios:
        return [f"scenario count differs: {batched.n_scenarios} vs {scalar.n_scenarios}"]
    out = []
    for rb, rs in zip(batched.rows, scalar.rows):
        if tuple(rb.splits) != tuple(rs.splits) or rb.feasible != rs.feasible:
            out.append(f"{rb.scenario.describe()}: batched {rb.splits} "
                       f"vs scalar {rs.splits}")
    return out
