"""Split-point selection algorithms (Sec. IV-B, Algorithms 1-3).

The port's copy of the reference's scalar solvers (``repro.core.solvers``):
pure Python, the same code line for line, so each solver returns the same
splits, costs and ``nodes_expanded`` as the reference's on the same
``cost_fn``.

All solvers minimize

    C(s) = combine_i CostSegment(s_{i-1}+1, s_i, i)          (Eq. 10)

over split configurations ``s = (s_1, ..., s_{N-1})`` with
``s_0 = 0 < s_1 < ... < s_{N-1} < s_N = L`` (Eq. 3), where
``combine`` is ``sum`` (paper-faithful, Eq. 5) or ``max`` (steady-state
pipeline bottleneck, used by pipeline planning).

Solvers take an opaque ``cost_fn(a, b, k) -> seconds`` so they are testable
against synthetic cost structures; segment costs are memoized since brute
force revisits each O(L^2) segment many times.

Every solver additionally accepts an optional **energy budget**
(``energy_fn(a, b, k) -> Joules`` + scalar ``energy_budget``): segments
whose energy exceeds the per-device budget are masked to +inf *before*
memoization, so search, pruning and feasibility lookahead all operate on
the constrained instance (see :func:`budget_masked`). Because every
device executes exactly one segment, the per-device constraint is exactly
this per-segment mask — ``brute_force`` on the masked instance is the
"enumerate, filter by budget, take min latency" oracle the batched
multi-channel solvers are property-tested against.

Implementation notes vs. the paper's pseudocode:
  * Alg. 1 line 5 iterates ``next in [pos+1, L-(N-k)]`` for every k≤N. At
    the final iteration (k = N) the segment must end exactly at L
    (``s_N = L``, Eq. 3); the pseudocode's open range would let incomplete
    configurations (cheaper, fewer layers) win line 12. We pin
    ``next = L`` at k = N — the obviously intended semantics.
  * Alg. 2/3 select N-1 split points; the cost of the implicit final
    segment [s_{N-1}+1, L] on device N is added to the reported total so
    totals are comparable across solvers.
"""

from __future__ import annotations

import heapq
import itertools
import random
import time
from dataclasses import dataclass, replace
from typing import Callable, Sequence

INF = float("inf")

CostFn = Callable[[int, int, int], float]


@dataclass(frozen=True)
class SolverResult:
    solver: str
    splits: tuple[int, ...]  # (s_1 .. s_{N-1})
    cost_s: float  # combined segment cost (no setup/feedback overheads)
    wall_time_s: float  # planner processing time (Figs. 3-4 right axes)
    nodes_expanded: int  # segment-cost evaluations (unique, memoized)
    variant: int | None = None  # winning variant index (None: no variant axis)

    @property
    def feasible(self) -> bool:
        return self.cost_s < INF


class _Memo:
    """Memoizing wrapper counting unique CostSegment evaluations."""

    def __init__(self, cost_fn: CostFn):
        self._fn = cost_fn
        self._cache: dict[tuple[int, int, int], float] = {}

    def __call__(self, a: int, b: int, k: int) -> float:
        key = (a, b, k)
        hit = self._cache.get(key)
        if hit is None:
            hit = self._fn(a, b, k)
            self._cache[key] = hit
        return hit

    @property
    def evals(self) -> int:
        return len(self._cache)


def budget_masked(
    cost_fn: CostFn,
    energy_fn: CostFn | None,
    energy_budget: float | None,
) -> CostFn:
    """``cost_fn`` with +inf wherever the segment's energy exceeds the
    per-device ``energy_budget``. With no energy model or no (finite)
    budget the original callable is returned unchanged, so the
    unconstrained path is bit-identical to the historical one."""
    if energy_fn is None or energy_budget is None or energy_budget == INF:
        return cost_fn

    def fn(a: int, b: int, k: int) -> float:
        if energy_fn(a, b, k) > energy_budget:
            return INF
        return cost_fn(a, b, k)

    return fn


@dataclass(frozen=True)
class VariantInstance:
    """One member of a model-variant bank at the scalar-solver level:
    the variant's own ``CostSegment`` callable (compressed payload +
    encoder already priced in), its energy callable (optional; encoder
    energy included), and its unitless accuracy proxy.

    The solvers stay opaque-callable pure: they never see
    :class:`~repro_torch.core.latency.BottleneckVariant` objects, only the
    per-variant cost functions — build instances with
    ``VariantInstance(replace(model, variant=v).cost_segment_fn(), ...)``
    or let :func:`repro_torch.core.planner.plan_split` do it."""

    cost_fn: CostFn
    energy_fn: CostFn | None = None
    accuracy_proxy: float = 1.0


def _as_variant(v) -> VariantInstance:
    return v if isinstance(v, VariantInstance) else VariantInstance(cost_fn=v)


def _best_variant(
    solver_fn: Callable[..., "SolverResult"],
    name: str,
    variants: Sequence["VariantInstance | CostFn"],
    accuracy_floor: float | None,
    L: int,
    N: int,
    energy_budget: float | None,
    **solver_kwargs,
) -> "SolverResult":
    """(split point, variant) joint optimization: run ``solver_fn`` once
    per bank member and keep the cheapest, preferring the LOWEST variant
    index on exact cost ties (the batched engine's first-minimum argmin
    over the stacked variant axis matches this tie-break bit-for-bit).

    ``accuracy_floor`` masks variants with ``accuracy_proxy < floor``
    before the solve — the variant-axis mirror of
    :func:`budget_masked`'s per-segment +inf masking. A bank whose every
    member is masked (or infeasible) yields the usual infeasible result
    with ``variant=None``."""
    if not variants:
        raise ValueError("variants must name at least one bank member")
    t0 = time.perf_counter()
    best: SolverResult | None = None
    best_idx: int | None = None
    nodes = 0
    for idx, entry in enumerate(_as_variant(v) for v in variants):
        if accuracy_floor is not None and entry.accuracy_proxy < accuracy_floor:
            continue
        res = solver_fn(entry.cost_fn, L, N, energy_fn=entry.energy_fn,
                        energy_budget=energy_budget, **solver_kwargs)
        nodes += res.nodes_expanded
        if res.feasible and (best is None or res.cost_s < best.cost_s):
            best, best_idx = res, idx
    wall = time.perf_counter() - t0
    if best is None:
        return SolverResult(name, (), INF, wall, nodes, variant=None)
    return replace(best, wall_time_s=wall, nodes_expanded=nodes,
                   variant=best_idx)


def total_energy(energy_fn: CostFn, splits: Sequence[int], L: int) -> float:
    """Total Joules of a full configuration (energy is additive across
    segments; the *constraint* is per-segment — see :func:`budget_masked`)."""
    bounds = [0, *splits, L]
    acc = 0.0
    for i in range(len(bounds) - 1):
        a, b = bounds[i] + 1, bounds[i + 1]
        if a > b:
            return INF
        e = energy_fn(a, b, i + 1)
        if e == INF:
            return INF
        acc += e
    return acc


def _combine_fn(combine: str) -> Callable[[float, float], float]:
    if combine == "sum":
        return lambda acc, c: acc + c
    if combine == "max":
        return max
    raise ValueError(f"unknown combine {combine!r}")


def _min_devices_suffix(cost_fn: CostFn, L: int, probe_k: int = 2) -> list[float]:
    """need[j] = minimum devices that can host layers [j..L] feasibly.

    Feasibility (finite cost) is prefix-monotone in segment extension in the
    latency model (memory grows with the segment), so greedily taking the
    longest feasible segment is optimal. Used as admissible lookahead: a
    partial configuration ending at ``pos`` with ``m`` devices left is a
    dead end iff need[pos+1] > m.

    This is a beyond-paper fix: the paper's Alg. 1-3 as written dead-end on
    memory-constrained instances (e.g. ResNet50 on ESP32-S3, Fig. 3) because
    they prune/pick without checking that the suffix remains packable."""
    need: list[float] = [INF] * (L + 2)
    need[L + 1] = 0.0
    for j in range(L, 0, -1):
        b_max = None
        for b in range(L, j - 1, -1):
            if cost_fn(j, b, probe_k) < INF:
                b_max = b
                break
        if b_max is None or need[b_max + 1] == INF:
            # greedy longest may strand the remainder only if *no* extent
            # works; fall back to scanning all feasible extents.
            best = INF
            for b in range(j, L + 1):
                if cost_fn(j, b, probe_k) < INF and need[b + 1] != INF:
                    best = min(best, 1.0 + need[b + 1])
            need[j] = best
        else:
            need[j] = 1.0 + need[b_max + 1]
    return need


def total_cost(cost_fn: CostFn, splits: Sequence[int], L: int, combine: str = "sum") -> float:
    """Combined cost of a full configuration."""
    comb = _combine_fn(combine)
    bounds = [0, *splits, L]
    acc = 0.0
    for i in range(len(bounds) - 1):
        a, b = bounds[i] + 1, bounds[i + 1]
        if a > b:
            return INF
        c = cost_fn(a, b, i + 1)
        if c == INF:
            return INF
        acc = comb(acc, c) if i else c
    return acc


# ---------------------------------------------------------------------------
# Algorithm 1 — Beam Search
# ---------------------------------------------------------------------------


def beam_search(
    cost_fn: CostFn,
    L: int,
    N: int,
    beam_width: int = 8,
    combine: str = "sum",
    feasibility_lookahead: bool = True,
    dominance: bool = True,
    *,
    energy_fn: CostFn | None = None,
    energy_budget: float | None = None,
    variants: Sequence[VariantInstance | CostFn] | None = None,
    accuracy_floor: float | None = None,
) -> SolverResult:
    """Beam Search for split-point optimization (Algorithm 1).

    ``variants`` switches on the (split point, variant) joint decision:
    the bank's per-variant cost/energy callables supersede
    ``cost_fn``/``energy_fn`` (pass ``cost_fn=None``) and the result
    reports the winning bank index in ``SolverResult.variant``;
    ``accuracy_floor`` masks bank members below it (see
    :func:`_best_variant`).

    Maintains the top-``beam_width`` partial configurations by cumulative
    cost; at iteration k each candidate ``(pos, cost, splits)`` is extended
    with every feasible next split ``next in [pos+1, L-(N-k)]`` (exactly L
    at k = N). ``feasibility_lookahead`` additionally prunes extensions
    whose suffix cannot be packed onto the remaining devices (see
    :func:`_min_devices_suffix`).

    ``dominance`` (beyond-paper): two partial configurations at the same
    ``pos`` after the same number of segments are interchangeable for the
    suffix — the cheaper one dominates for BOTH combine semantics. Keeping
    only the best candidate per position before truncation removes the
    degenerate ties that otherwise fill the beam under the ``max``
    (bottleneck) objective, where every short-prefix candidate scores the
    same low cumulative max.

    Pruning additionally ranks candidates by an ADMISSIBLE completion
    bound (A*-style): segment costs are superadditive (splitting adds
    per-segment overheads and cut transmissions), so the cost of the whole
    suffix as one segment lower-bounds the sum of any segmentation, and
    suffix/(N-k) lower-bounds its max. Without this, max-combine beams
    systematically favor short prefixes (low running max) and miss
    balanced optima."""
    if variants is not None:
        return _best_variant(
            beam_search, "beam", variants, accuracy_floor, L, N,
            energy_budget, beam_width=beam_width, combine=combine,
            feasibility_lookahead=feasibility_lookahead, dominance=dominance)
    t0 = time.perf_counter()
    memo = _Memo(budget_masked(cost_fn, energy_fn, energy_budget))
    comb = _combine_fn(combine)
    need = _min_devices_suffix(memo, L) if feasibility_lookahead else None

    def completion_bound(pos: int, k: int) -> float:
        """Admissible lower bound on the combined cost of layers
        [pos+1, L] split across devices k+1..N."""
        if pos >= L:
            return 0.0
        rem = N - k
        whole = memo(pos + 1, L, min(k + 1, N))
        if whole == INF:
            return 0.0  # feasibility handled by the lookahead
        return whole / rem if combine == "max" else whole

    # candidates: (cumulative_cost, pos, splits_tuple)
    beam: list[tuple[float, int, tuple[int, ...]]] = [(0.0, 0, ())]
    for k in range(1, N + 1):
        new: list[tuple[float, int, tuple[int, ...]]] = []
        for cost, pos, splits in beam:
            lo = pos + 1
            hi = L - (N - k)
            nxt_range = (L,) if k == N else range(lo, hi + 1)
            for nxt in nxt_range:
                if nxt < lo:
                    continue
                c_seg = memo(pos + 1, nxt, k)
                if c_seg == INF:
                    continue
                if need is not None and nxt < L and need[nxt + 1] > N - k:
                    continue  # dead end: suffix cannot fit remaining devices
                # costs are non-negative, so comb(0, c) == c for both combines
                new.append((comb(cost, c_seg), nxt, splits + (nxt,)))
        if not new:
            return SolverResult("beam", (), INF, time.perf_counter() - t0, memo.evals)
        if dominance:
            best_by_pos: dict[int, tuple[float, int, tuple[int, ...]]] = {}
            for cand in new:
                cur = best_by_pos.get(cand[1])
                if cur is None or cand[0] < cur[0]:
                    best_by_pos[cand[1]] = cand
            new = list(best_by_pos.values())
        if k < N:
            new.sort(key=lambda t: comb(t[0], completion_bound(t[1], k)))
            beam = new[:beam_width]
        else:
            beam = heapq.nsmallest(beam_width, new, key=lambda t: t[0])

    best_cost, _, best_splits = min(beam, key=lambda t: t[0])
    return SolverResult(
        "beam", best_splits[:-1], best_cost, time.perf_counter() - t0, memo.evals
    )


# ---------------------------------------------------------------------------
# Algorithm 2 — Greedy Search
# ---------------------------------------------------------------------------


def greedy_search(
    cost_fn: CostFn,
    L: int,
    N: int,
    combine: str = "sum",
    feasibility_lookahead: bool = True,
    *,
    energy_fn: CostFn | None = None,
    energy_budget: float | None = None,
    variants: Sequence[VariantInstance | CostFn] | None = None,
    accuracy_floor: float | None = None,
) -> SolverResult:
    """Greedy Search (Algorithm 2): at step k pick the split minimizing the
    immediate segment cost (Eq. 11). ``variants``/``accuracy_floor``:
    joint (split, variant) decision as in :func:`beam_search`."""
    if variants is not None:
        return _best_variant(
            greedy_search, "greedy", variants, accuracy_floor, L, N,
            energy_budget, combine=combine,
            feasibility_lookahead=feasibility_lookahead)
    t0 = time.perf_counter()
    memo = _Memo(budget_masked(cost_fn, energy_fn, energy_budget))
    need = _min_devices_suffix(memo, L) if feasibility_lookahead else None
    pos = 0
    splits: list[int] = []
    for k in range(1, N):
        best_next, best_cost = None, INF
        for nxt in range(pos + 1, L - (N - k) + 1):
            c = memo(pos + 1, nxt, k)
            if need is not None and need[nxt + 1] > N - k:
                continue
            if c < best_cost:
                best_cost, best_next = c, nxt
        if best_next is None:
            return SolverResult("greedy", (), INF, time.perf_counter() - t0, memo.evals)
        splits.append(best_next)
        pos = best_next
    cost = total_cost(memo, splits, L, combine)
    return SolverResult("greedy", tuple(splits), cost, time.perf_counter() - t0, memo.evals)


# ---------------------------------------------------------------------------
# Algorithm 3 — First-Fit Search
# ---------------------------------------------------------------------------


def first_fit_search(
    cost_fn: CostFn,
    L: int,
    N: int,
    thresholds: Sequence[float] | float | None = None,
    combine: str = "sum",
    feasibility_lookahead: bool = True,
    *,
    energy_fn: CostFn | None = None,
    energy_budget: float | None = None,
    variants: Sequence[VariantInstance | CostFn] | None = None,
    accuracy_floor: float | None = None,
) -> SolverResult:
    """First-Fit Search (Algorithm 3): scan left-to-right and accept the
    first split whose segment cost is within the device-k threshold tau_k;
    fall back to the last feasible position otherwise.

    When ``thresholds`` is None, tau_k defaults to the single-device
    whole-model cost divided by N (a uniform-share budget). When the whole
    model does not fit one device (cost INF), the budget falls back to the
    per-device sum of longest-feasible-segment costs.

    ``variants``/``accuracy_floor``: joint (split, variant) decision as
    in :func:`beam_search`."""
    if variants is not None:
        return _best_variant(
            first_fit_search, "first_fit", variants, accuracy_floor, L, N,
            energy_budget, thresholds=thresholds, combine=combine,
            feasibility_lookahead=feasibility_lookahead)
    t0 = time.perf_counter()
    memo = _Memo(budget_masked(cost_fn, energy_fn, energy_budget))
    need = _min_devices_suffix(memo, L) if feasibility_lookahead else None
    if thresholds is None:
        whole = memo(1, L, 1)
        if whole == INF:
            # infeasible-on-one-device models: budget = mean feasible-segment cost
            finite = [memo(a, a, 2) for a in range(1, L + 1)]
            finite = [c for c in finite if c < INF]
            whole = (sum(finite) if finite else 1.0) * 1.5
        thresholds = [whole / N] * N
    elif isinstance(thresholds, (int, float)):
        thresholds = [float(thresholds)] * N

    pos = 0
    splits: list[int] = []
    for k in range(1, N):
        chosen = False
        last_feasible = None
        for nxt in range(pos + 1, L - (N - k) + 1):
            c = memo(pos + 1, nxt, k)
            if c == INF or (need is not None and need[nxt + 1] > N - k):
                continue
            last_feasible = nxt
            if c <= thresholds[k - 1]:
                splits.append(nxt)
                pos = nxt
                chosen = True
                break
        if not chosen:
            # Alg. 3 line 14: 'the last feasible split point before
            # violating the device constraint'.
            fallback = last_feasible if last_feasible is not None else L - (N - k)
            splits.append(fallback)
            pos = fallback
    cost = total_cost(memo, splits, L, combine)
    return SolverResult("first_fit", tuple(splits), cost, time.perf_counter() - t0, memo.evals)


# ---------------------------------------------------------------------------
# Baselines — Random-Fit and Brute-Force (Fig. 4)
# ---------------------------------------------------------------------------


def random_fit(
    cost_fn: CostFn,
    L: int,
    N: int,
    trials: int = 1,
    seed: int = 0,
    combine: str = "sum",
    *,
    energy_fn: CostFn | None = None,
    energy_budget: float | None = None,
    variants: Sequence[VariantInstance | CostFn] | None = None,
    accuracy_floor: float | None = None,
) -> SolverResult:
    """Random-Fit: draw ``trials`` uniformly random valid configurations and
    keep the best (the paper's Random-Fit baseline corresponds to trials=1).
    ``variants``/``accuracy_floor``: joint (split, variant) decision as in
    :func:`beam_search` (every bank member sees the same draws — a paired
    comparison)."""
    if variants is not None:
        return _best_variant(
            random_fit, "random_fit", variants, accuracy_floor, L, N,
            energy_budget, trials=trials, seed=seed, combine=combine)
    t0 = time.perf_counter()
    memo = _Memo(budget_masked(cost_fn, energy_fn, energy_budget))
    rng = random.Random(seed)
    best: tuple[float, tuple[int, ...]] = (INF, ())
    for _ in range(max(1, trials)):
        splits = tuple(sorted(rng.sample(range(1, L), N - 1))) if N > 1 else ()
        c = total_cost(memo, splits, L, combine)
        if c < best[0]:
            best = (c, splits)
    return SolverResult("random_fit", best[1], best[0], time.perf_counter() - t0, memo.evals)


def brute_force(
    cost_fn: CostFn,
    L: int,
    N: int,
    combine: str = "sum",
    max_candidates: int | None = None,
    *,
    energy_fn: CostFn | None = None,
    energy_budget: float | None = None,
    variants: Sequence[VariantInstance | CostFn] | None = None,
    accuracy_floor: float | None = None,
) -> SolverResult:
    """Brute-Force: enumerate all C(L-1, N-1) configurations (Fig. 4).

    ``max_candidates`` optionally caps the enumeration (the paper reports
    ~7857 s for 6 devices; the cap keeps CI runs bounded while preserving
    exactness whenever the space is smaller than the cap).

    With ``energy_fn``/``energy_budget`` this is the budget-filtered
    enumeration oracle: every configuration containing an over-budget
    segment totals +inf and can never win. With ``variants`` it is the
    full (split, variant) enumeration oracle the batched variant-bank
    engine is property-tested against."""
    if variants is not None:
        return _best_variant(
            brute_force, "brute_force", variants, accuracy_floor, L, N,
            energy_budget, combine=combine, max_candidates=max_candidates)
    t0 = time.perf_counter()
    memo = _Memo(budget_masked(cost_fn, energy_fn, energy_budget))
    best: tuple[float, tuple[int, ...]] = (INF, ())
    n_seen = 0
    for combo in itertools.combinations(range(1, L), N - 1):
        n_seen += 1
        if max_candidates is not None and n_seen > max_candidates:
            break
        c = total_cost(memo, combo, L, combine)
        if c < best[0]:
            best = (c, combo)
    return SolverResult("brute_force", best[1], best[0], time.perf_counter() - t0, memo.evals)


# ---------------------------------------------------------------------------
# Exact DP (beyond-paper): O(L^2 N) optimum for both objectives
# ---------------------------------------------------------------------------


def optimal_dp(
    cost_fn: CostFn,
    L: int,
    N: int,
    combine: str = "sum",
    *,
    energy_fn: CostFn | None = None,
    energy_budget: float | None = None,
    variants: Sequence[VariantInstance | CostFn] | None = None,
    accuracy_floor: float | None = None,
) -> SolverResult:
    """Exact optimum via dynamic programming (beyond-paper reference).

    dp[k][b] = best combined cost of placing layers [1..b] on devices
    [1..k]; transition over the last segment start. Both ``sum`` and
    ``max`` combine are decomposable. Used to (a) certify Beam Search
    quality in tests and (b) give pipeline planning an exact fallback at
    interactive speeds (the full Brute-Force table of Fig. 4 is
    exponential; DP is quadratic). ``variants``/``accuracy_floor``:
    joint (split, variant) decision as in :func:`beam_search` — the DP
    runs once per bank member, exactly optimal per variant, so the
    banked result is exactly optimal over the joint space."""
    if variants is not None:
        return _best_variant(
            optimal_dp, "optimal_dp", variants, accuracy_floor, L, N,
            energy_budget, combine=combine)
    t0 = time.perf_counter()
    memo = _Memo(budget_masked(cost_fn, energy_fn, energy_budget))
    comb = _combine_fn(combine)

    # dp[b] after k devices; parent pointers for reconstruction
    dp = [INF] * (L + 1)
    parent: list[list[int]] = [[-1] * (L + 1) for _ in range(N + 1)]
    for b in range(1, L + 1):
        dp[b] = memo(1, b, 1)
    for k in range(2, N + 1):
        ndp = [INF] * (L + 1)
        for b in range(k, L + 1):
            best, arg = INF, -1
            for a in range(k - 1, b):
                if dp[a] == INF:
                    continue
                c_seg = memo(a + 1, b, k)
                if c_seg == INF:
                    continue
                cand = comb(dp[a], c_seg)
                if cand < best:
                    best, arg = cand, a
            ndp[b] = best
            parent[k][b] = arg
        dp = ndp

    if dp[L] == INF:
        return SolverResult("optimal_dp", (), INF, time.perf_counter() - t0, memo.evals)

    splits: list[int] = []
    b = L
    for k in range(N, 1, -1):
        a = parent[k][b]
        splits.append(a)
        b = a
    splits.reverse()
    return SolverResult("optimal_dp", tuple(splits), dp[L], time.perf_counter() - t0, memo.evals)


SOLVERS: dict[str, Callable[..., SolverResult]] = {
    "beam": beam_search,
    "greedy": greedy_search,
    "first_fit": first_fit_search,
    "random_fit": random_fit,
    "brute_force": brute_force,
    "optimal_dp": optimal_dp,
}
