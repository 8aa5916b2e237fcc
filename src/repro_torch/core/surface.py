"""Precomputed degradation surfaces for O(1) adaptive re-planning.

The port's counterpart of ``repro.core.surface``, line for line. Only the
solve dispatch differs: ``solver="batched_dp"`` runs on the card by
default. An unbudgeted build takes the fused CUDA kernel, which consumes
the device-local stack and the transmission vectors, so the stacked
tensor ``C`` never goes to the card (the twin of the reference's
``pallas`` branch); a budgeted build takes the dense kernel on the masked
``C``; ``backend="torch"`` runs the dense plain version (the twin of the
reference's ``jax``). The reference's ``build_surfaces`` is a shim over
its planner tier, which the port does not have yet: here it calls
:func:`_build_surfaces_impl` directly.

The adaptive manager's ``observe()`` used to re-solve Beam Search over
every protocol on every hop measurement — a fleet controller calls it on
every packet, so the solver was the hot loop. But the solver's *input*
only drifts along two axes per protocol: the estimated per-packet time
and the estimated loss rate (everything else — the model, the devices,
the protocol constants — is fixed at deployment). That makes the whole
decision problem precomputable:

* :class:`DegradationSurface` — for each protocol, a dense
  (packet-time × loss) grid of link conditions; at every node the best
  plan (splits + tuned activation chunk), its end-to-end latency, and
  the runner-up plan from the protocol's plan portfolio. All nodes of
  all protocols are solved in ONE batched sweep-engine pass
  (:func:`repro_torch.core.sweep.solve_batched` over a stacked cost tensor).

* *Switch points* — the link-condition boundaries where the argmin plan
  changes between adjacent grid nodes. These are the degradation
  thresholds the paper's Sec. VI future work asks for: "at what point
  does the optimal split move / the protocol switch pay?"

* Bilinear interpolation of latency between grid nodes, so the runtime
  gets a continuous latency estimate from a discrete surface.

* :func:`build_surfaces` — surface *families* for several fleet sizes
  in ONE batched solve (all-k DP table sharing; all-k beam/greedy
  block batching) — no per-N re-solve loop on any solver path.

At a grid node the stored decision is **exactly** what the legacy
re-solve path would compute for the same estimator state (same solver,
same chunk tuning, same ``end_to_end_s`` floats — the benchmark
``benchmarks/surface_replan.py`` asserts ``==`` parity node-by-node on
the NumPy float64 path). Between nodes the plan comes from the nearest
node and the latency from bilinear interpolation; outside the grid's
envelope the runtime falls back to an exact re-solve.
"""

from __future__ import annotations

import time
from bisect import bisect_right
from dataclasses import dataclass, replace
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import sweep as SW
from repro_torch.core.latency import BottleneckVariant, LinkProfile, SplitCostModel
from repro_torch.device import resolve_device, resolve_dtype

INF = float("inf")

# Loss estimates at or above this map to the identical re-fitted link
# (the refit_link clamp), so surface queries clamp the loss coordinate
# here EXACTLY — the loss-axis mirror of the packet-time saturation
# floor. Keep in sync with nothing: refit_link below is the single
# source and everything else reads this constant.
LOSS_CLAMP = 0.9

__all__ = [
    "DEFAULT_LOSS_GRID",
    "DEFAULT_PT_SCALES",
    "DegradationSurface",
    "ProtocolSurface",
    "SurfaceLookup",
    "SwitchPoint",
    "build_surface",
    "build_surfaces",
    "optimize_chunk_size",
    "refit_link",
]

# Default envelope: packet time from nominal up to 512x degradation
# (geometric — the adaptive example's deepest phase is 400x), loss from
# the clean channel up to 30%.
DEFAULT_PT_SCALES: tuple[float, ...] = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0,
                                        64.0, 128.0, 256.0, 512.0)
DEFAULT_LOSS_GRID: tuple[float, ...] = (0.0, 0.05, 0.10, 0.20, 0.30)


def refit_link(base: LinkProfile, packet_time_s: float,
               loss_p: float) -> LinkProfile:
    """Map an estimator state (per-packet time, loss) onto ``base``.

    Args:
      base: the protocol's deployment-time :class:`LinkProfile`.
      packet_time_s: estimated expected per-packet time.
      loss_p: estimated loss probability, clamped into
        ``[0, LOSS_CLAMP]`` BEFORE any arithmetic — every estimate at
        or above the clamp maps to the identical link, so surface
        lookups may clamp the loss coordinate exactly (the loss-axis
        mirror of the packet-time saturation floor).

    Returns the base profile re-fitted so that
    ``profile.packet_time_s()`` reproduces the estimate: the
    serialization term keeps the base rate, the residual moves into the
    ack/overhead term (floored at 0 — estimates faster than loss-free
    serialization + propagation saturate, which is why surface axes
    include that floor as their minimum).

    Invariant (single-sourcing): this function is the ONLY
    estimator-state → :class:`LinkProfile` mapping. Both
    :meth:`LinkEstimator.current_profile
    <repro_torch.core.adaptive.LinkEstimator.current_profile>` and surface
    construction call it, so a surface node's link reproduces the
    estimator's re-fitted profile bit-for-bit at the same state.
    Changing either caller to do its own mapping (or editing this
    arithmetic in one place only) breaks the node-exact ``==`` parity
    that ``tests/test_surface.py`` and ``benchmarks/surface_replan.py``
    assert."""
    loss = min(max(loss_p, 0.0), LOSS_CLAMP)
    serial = base.mtu_bytes / (base.rate_bytes_per_s * (1.0 - loss))
    t_ack = max(0.0, packet_time_s - serial - base.t_prop_s)
    return replace(base, t_ack_s=t_ack, loss_p=loss)


def optimize_chunk_size(
    link: LinkProfile,
    cut_bytes: Sequence[int],
    chunk_candidates: Sequence[int] | None = None,
) -> tuple[int, float]:
    """Best activation chunk size for a set of cut sizes (Eq. 7 summed
    over the plan's hops). Candidates default to divisors-of-MTU-ish
    steps below the protocol MTU."""
    if chunk_candidates is None:
        mtu = link.mtu_bytes
        chunk_candidates = sorted({mtu, mtu * 3 // 4, mtu // 2, 1200, 250}
                                  & set(range(1, mtu + 1))
                                  | {mtu})
        chunk_candidates = [c for c in chunk_candidates if 0 < c <= mtu]
    best = (link.mtu_bytes, float("inf"))
    for chunk in chunk_candidates:
        trial = replace(link, mtu_bytes=chunk)
        total = sum(trial.transmission_latency_s(b) for b in cut_bytes)
        if total < best[1]:
            best = (chunk, total)
    return best


# ---------------------------------------------------------------------------
# Surface data model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SwitchPoint:
    """A link-condition boundary where the argmin plan changes.

    The plan flips somewhere between ``lo`` and ``hi`` on ``axis``
    (holding the other coordinate at ``fixed``); ``plan_lo``/``plan_hi``
    are the best splits on either side."""

    protocol: str
    axis: str  # "packet_time_s" | "loss_p"
    fixed: float  # the other coordinate's grid value
    lo: float
    hi: float
    plan_lo: tuple[int, ...]
    plan_hi: tuple[int, ...]


@dataclass(frozen=True)
class SurfaceLookup:
    """One surface query: the nearest node's decision plus the
    bilinearly interpolated latency at the exact query point."""

    protocol: str
    splits: tuple[int, ...]
    chunk_bytes: int
    latency_s: float  # bilinear interpolation at the query point
    node_latency_s: float  # the nearest node's stored latency
    feasible: bool
    in_envelope: bool
    # the node's adopted bottleneck variant: its index into the bank the
    # surface was built with (0 = the bank's first entry, and also the
    # value on surfaces built without a bank — the single-variant case)
    variant: int = 0


@dataclass(frozen=True)
class ProtocolSurface:
    """One protocol's (packet-time × loss) decision grid."""

    protocol: str
    base: LinkProfile
    packet_time_s: tuple[float, ...]  # (T,) ascending
    loss_p: tuple[float, ...]  # (G,) ascending
    splits: np.ndarray  # (T, G, N-1) int64, -1 where infeasible
    chunk_bytes: np.ndarray  # (T, G) int64
    latency_s: np.ndarray  # (T, G) float64, +inf where infeasible
    runner_splits: np.ndarray  # (T, G, N-1) int64, -1 where absent
    runner_latency_s: np.ndarray  # (T, G) float64, +inf where absent
    # per-node winning bottleneck-variant indices into the bank the
    # surface was built with; None on surfaces built without a bank
    variant: np.ndarray | None = None  # (T, G) int64

    def __post_init__(self):
        # hot-path caches: plain-Python node decisions and latency rows so
        # lookups never touch numpy scalars (observe() calls this per hop)
        T, G = len(self.packet_time_s), len(self.loss_p)
        nodes = [[None] * G for _ in range(T)]
        lat = [[0.0] * G for _ in range(T)]
        for i in range(T):
            for j in range(G):
                z = float(self.latency_s[i, j])
                sp = self.splits[i, j]
                feas = not (sp.size and (sp < 0).any()) and np.isfinite(z)
                vi = 0 if self.variant is None else int(self.variant[i, j])
                nodes[i][j] = SurfaceLookup(
                    protocol=self.protocol,
                    splits=tuple(int(x) for x in sp) if feas else (),
                    chunk_bytes=int(self.chunk_bytes[i, j]),
                    latency_s=z, node_latency_s=z,
                    feasible=feas, in_envelope=True,
                    variant=max(vi, 0),
                )
                lat[i][j] = z
        object.__setattr__(self, "_nodes", nodes)
        object.__setattr__(self, "_lat", lat)

    @property
    def n_nodes(self) -> int:
        return len(self.packet_time_s) * len(self.loss_p)

    def node(self, i: int, j: int) -> SurfaceLookup:
        return self._nodes[i][j]


def _cell(axis: Sequence[float], x: float,
          clamp_low: bool = False) -> tuple[int, int, float, bool]:
    """Bracket ``x`` in ``axis``: (i0, i1, weight toward i1, inside).

    Clamps outside the envelope (weight 0, ``inside=False``). At an
    exact node the weight is exactly 0.0, so interpolation returns the
    node value bitwise. ``clamp_low`` treats below-minimum queries as
    inside — used for the packet-time axis, whose minimum is the
    :func:`refit_link` saturation floor (every packet time at or below
    it maps to the identical link, so the clamp is exact, not an
    approximation)."""
    if x <= axis[0]:
        return 0, 0, 0.0, clamp_low or x == axis[0]
    if x >= axis[-1]:
        n = len(axis) - 1
        return n, n, 0.0, x == axis[-1]
    i = bisect_right(axis, x) - 1  # axis[i] <= x < axis[i+1]
    if axis[i] == x:
        return i, i, 0.0, True
    return i, i + 1, (x - axis[i]) / (axis[i + 1] - axis[i]), True


def _bilinear(z, i0, i1, wt, j0, j1, wl) -> float:
    """Weighted corner sum over nested-list rows, skipping zero-weight
    corners so an infeasible (+inf) corner outside the active cell edge
    cannot poison an on-node or on-edge query with inf*0 = nan."""
    acc = 0.0
    r0, r1 = z[i0], z[i1]
    for w, zz in (((1 - wt) * (1 - wl), r0[j0]),
                  (wt * (1 - wl), r1[j0]),
                  ((1 - wt) * wl, r0[j1]),
                  (wt * wl, r1[j1])):
        if w:
            acc += w * zz
    return acc


@dataclass(frozen=True)
class DegradationSurface:
    """Per-protocol degradation surfaces + cross-protocol argmin lookup."""

    protocols: Mapping[str, ProtocolSurface]
    n_devices: int
    solver: str
    build_time_s: float
    solve_time_s: float  # batched sweep-engine passes only

    def __post_init__(self):
        object.__setattr__(self, "protocols", dict(self.protocols))
        object.__setattr__(self, "_env", {
            name: (p.packet_time_s[0], p.packet_time_s[-1],
                   p.loss_p[0], p.loss_p[-1])
            for name, p in self.protocols.items()
        })

    @property
    def n_nodes(self) -> int:
        return sum(p.n_nodes for p in self.protocols.values())

    def envelope(self, protocol: str) -> tuple[tuple[float, float],
                                               tuple[float, float]]:
        plo, phi, llo, lhi = self._env[protocol]
        return ((plo, phi), (llo, lhi))

    def in_envelope(self, protocol: str, packet_time_s: float,
                    loss_p: float) -> bool:
        """Below-minimum packet times count as inside: the axis minimum
        is the refit saturation floor, below which every estimate maps
        to the same link (see :func:`_cell`'s ``clamp_low``). Loss is
        clamped at ``LOSS_CLAMP`` the same way: every estimate at or
        above it re-fits to the identical link, so an axis reaching the
        clamp covers all heavier loss exactly."""
        plo, phi, llo, lhi = self._env[protocol]
        loss = min(loss_p, LOSS_CLAMP)
        return packet_time_s <= phi and llo <= loss <= lhi

    def covers(self, states: Mapping[str, tuple[float, float]]) -> bool:
        """True when EVERY ``{protocol: (packet_time_s, loss_p)}`` state
        is inside its protocol's envelope — the condition under which
        :meth:`best_lookup` can rank protocols without a re-solve (the
        async rebuilder re-centers axes precisely so the drifted states
        satisfy this on the rebuilt surface)."""
        return all(self.in_envelope(name, pt, lp)
                   for name, (pt, lp) in states.items())

    def lookup(self, protocol: str, packet_time_s: float,
               loss_p: float) -> SurfaceLookup:
        """Nearest-node plan + bilinearly interpolated latency."""
        p = self.protocols[protocol]
        i0, i1, wt, ok_t = _cell(p.packet_time_s, packet_time_s,
                                 clamp_low=True)
        j0, j1, wl, ok_l = _cell(p.loss_p, min(loss_p, LOSS_CLAMP))
        ni = i1 if wt >= 0.5 else i0
        nj = j1 if wl >= 0.5 else j0
        node = p._nodes[ni][nj]
        lat = _bilinear(p._lat, i0, i1, wt, j0, j1, wl)
        if lat == node.latency_s and ok_t and ok_l:
            return node  # on-node query: hand back the cached decision
        return replace(node, latency_s=lat, in_envelope=ok_t and ok_l)

    def latency_at(self, protocol: str, packet_time_s: float,
                   loss_p: float) -> float:
        """Bilinear latency interpolation at an arbitrary link state."""
        return self.lookup(protocol, packet_time_s, loss_p).latency_s

    def best_lookup(
        self, states: Mapping[str, tuple[float, float]]
    ) -> SurfaceLookup | None:
        """Argmin over protocols, each queried at its own estimator
        state ``(packet_time_s, loss_p)`` — the O(1) replacement for the
        per-observe re-solve. Returns None when ANY state has left its
        protocol's envelope (the precomputed decisions can no longer
        rank that protocol, so the caller must re-solve exactly) or when
        no queried node is feasible."""
        best_lat = INF
        best: SurfaceLookup | None = None
        for name, (pt, lp) in states.items():
            p = self.protocols[name]
            i0, i1, wt, ok_t = _cell(p.packet_time_s, pt, clamp_low=True)
            j0, j1, wl, ok_l = _cell(p.loss_p, min(lp, LOSS_CLAMP))
            if not (ok_t and ok_l):
                return None
            node = p._nodes[i1 if wt >= 0.5 else i0][j1 if wl >= 0.5 else j0]
            if not node.feasible:
                continue
            lat = _bilinear(p._lat, i0, i1, wt, j0, j1, wl)
            if lat < best_lat:
                best_lat, best = lat, node
        if best is None or best_lat == best.latency_s:
            return best
        return replace(best, latency_s=best_lat)

    # -- switch points ------------------------------------------------------
    def switch_points(self, protocol: str | None = None) -> list[SwitchPoint]:
        """Boundaries between adjacent grid nodes where the best plan
        changes — the precomputed 'when does the split move' thresholds.
        Feasibility boundaries are not plan switches: pairs with an
        infeasible side are skipped rather than reported with the ``-1``
        sentinel as a phantom plan."""
        names = [protocol] if protocol is not None else list(self.protocols)
        out: list[SwitchPoint] = []
        for name in names:
            p = self.protocols[name]
            T, G = len(p.packet_time_s), len(p.loss_p)

            def plan(i, j):
                node = p._nodes[i][j]
                return node.splits if node.feasible else None

            for j in range(G):
                for i in range(T - 1):
                    a, b = plan(i, j), plan(i + 1, j)
                    if a is not None and b is not None and a != b:
                        out.append(SwitchPoint(
                            name, "packet_time_s", p.loss_p[j],
                            p.packet_time_s[i], p.packet_time_s[i + 1], a, b))
            for i in range(T):
                for j in range(G - 1):
                    a, b = plan(i, j), plan(i, j + 1)
                    if a is not None and b is not None and a != b:
                        out.append(SwitchPoint(
                            name, "loss_p", p.packet_time_s[i],
                            p.loss_p[j], p.loss_p[j + 1], a, b))
        return out

    # -- construction -------------------------------------------------------
    @classmethod
    def from_scenario_grid(
        cls,
        grid,  # sweep.ScenarioGrid
        model: str | None = None,
        n_devices: int | None = None,
        mix: str | None = None,
        **kwargs,
    ) -> "DegradationSurface":
        """Build a surface whose axes come from a
        :class:`~repro_torch.core.sweep.ScenarioGrid`'s link axes: packet
        times from the grid's ``rate_scale`` values, losses from its
        ``loss_p`` values (None → each protocol's base loss).
        ``n_devices`` defaults to the grid's largest fleet size; ``mix``
        selects one of the grid's ``device_mixes`` (defaults to the
        shared ``devices`` fleet, or the grid's only mix)."""
        if n_devices is None:
            n_devices = max(grid.n_devices)
        cost_model, pt_scales, losses = _grid_surface_args(grid, model, mix)
        return build_surface(
            cost_model, grid.links, n_devices,
            pt_scale=pt_scales, loss_p=losses,
            **kwargs,
        )


def _grid_surface_args(grid, model: str | None, mix: str | None):
    """Shared ScenarioGrid → surface-axis derivation (single- and
    multi-N construction paths must never drift apart)."""
    if model is None:
        if len(grid.models) != 1:
            raise ValueError(
                f"grid has models {sorted(grid.models)}; pass model=...")
        model = next(iter(grid.models))
    if mix is None and not grid.devices:
        if len(grid.device_mixes or {}) != 1:
            raise ValueError(
                f"grid has device mixes {sorted(grid.device_mixes or {})} "
                f"and no shared devices; pass mix=...")
        mix = next(iter(grid.device_mixes))
    if mix is not None:
        if not grid.device_mixes:
            raise ValueError(
                f"mix={mix!r} given but the grid has no device_mixes")
        if mix not in grid.device_mixes:
            raise ValueError(f"unknown device mix {mix!r}; "
                             f"options: {sorted(grid.device_mixes)}")
        devices = grid.device_mixes[mix]
    else:
        devices = tuple(grid.devices)
    cost_model = SplitCostModel(
        profile=grid.models[model], devices=devices,
        link=next(iter(grid.links.values())), objective=grid.objective,
    )
    # rate_scale scales the serialization rate; for the surface axis we
    # take 1/rs as the packet-time scale (exact for overhead-free links,
    # a conservative envelope otherwise). None loss entries pass through
    # and resolve to each protocol's base loss, like link_variant.
    pt_scales = tuple(sorted({1.0 / rs for rs in grid.rate_scale}))
    return cost_model, pt_scales or DEFAULT_PT_SCALES, tuple(grid.loss_p)


def build_surface(
    cost_model: SplitCostModel,
    protocols: Mapping[str, LinkProfile],
    n_devices: int,
    pt_scale: Sequence[float] = DEFAULT_PT_SCALES,
    loss_p: Sequence[float | None] | None = DEFAULT_LOSS_GRID,
    solver: str = "batched_beam",
    backend: str | None = None,
    beam_width: int = 8,
    chunk_candidates: Sequence[int] | None = None,
    energy_budget: float | None = None,
    variants: Sequence[BottleneckVariant] | None = None,
    accuracy_floor: float | None = None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> DegradationSurface:
    """Precompute a :class:`DegradationSurface` with the sweep engine.

    For every protocol, a (packet-time × loss) grid of estimator states
    is mapped onto link profiles (:func:`refit_link`), their
    transmission vectors are stacked against the shared device-local
    cost tensor, and ALL nodes of ALL protocols are solved in one
    batched pass. Each node's winning plan then gets its activation
    chunk tuned and its end-to-end latency priced exactly as the legacy
    per-observe path would — the stored decision at a node IS the
    re-solve decision for that state.

    Args:
      cost_model: device/model side of the problem (its link is ignored;
        ``protocols`` supplies the links). Heterogeneous per-device
        fleets work: device ``k`` is ``cost_model.device(k)``.
      protocols: name → base :class:`LinkProfile` for every candidate
        protocol.
      n_devices: the fleet size to plan for. For several fleet sizes at
        once use :func:`build_surfaces` (one batched solve for all).
      pt_scale: multipliers on each protocol's nominal
        :meth:`~repro_torch.core.latency.LinkProfile.packet_time_s`; the
        refit saturation floor is always added as the axis minimum.
      loss_p: absolute loss values; ``None`` entries resolve to each
        protocol's base loss (``loss_p=None`` → base loss only) — the
        same convention as :meth:`ScenarioGrid.link_variant
        <repro_torch.core.sweep.ScenarioGrid.link_variant>`.
      solver: a :data:`repro_torch.core.sweep.BATCHED_SOLVERS` name.
      backend: ``None`` (``"cuda"`` for ``solver="batched_dp"``,
        ``"numpy"`` for beam and greedy, which take no other backend),
        or a :data:`repro_torch.core.sweep.DP_BACKENDS` key for
        ``batched_dp``: ``"cuda"`` (the fused CUDA kernel solves straight
        from the local stack + transmission vectors; the dense kernel
        when a budget is set), ``"torch"`` (the dense plain version) or
        ``"numpy"`` (the node-exact ``==`` parity path). ``"cuda"`` and
        ``"torch"`` run in ``dtype`` (float32 by default), so their node
        decisions are cost-close rather than bit-identical to the
        float64 re-solve oracle.
      beam_width: Algorithm-1 width when ``solver="batched_beam"``.
      chunk_candidates: explicit activation-chunk candidates for
        :func:`optimize_chunk_size` (None → per-protocol defaults).
      energy_budget: optional per-device Joule cap. Segments whose
        energy (:meth:`SplitCostModel.energy_cost_tensor
        <repro_torch.core.latency.SplitCostModel.energy_cost_tensor>` at each
        node's link) exceeds the budget are masked to +inf before the
        batched solve, so every surface node minimizes latency subject
        to the budget (:func:`repro_torch.core.sweep.apply_energy_budget`).
        The cuda backend takes the dense kernel when a budget is set
        (the fused kernel prices raw local + TX only).
      variants: optional bottleneck-variant bank. Every node then
        decides (split, variant) jointly — the variant axis folds into
        the node axis (one batched solve still prices everything, fused
        kernel included) and each node stores the winning bank
        index (``SurfaceLookup.variant``), with chunk tuning and
        latency priced on the winning variant's compressed cuts.
      accuracy_floor: with ``variants``, masks bank entries whose
        ``accuracy_proxy`` is below the floor before the solve
        (:func:`repro_torch.core.sweep.apply_accuracy_floor`) — every node
        then minimizes latency subject to the accuracy constraint.
      device / dtype: where and in which type the ``"cuda"`` and
        ``"torch"`` backends run (``device=None`` is the card).

    Returns the surface for ``n_devices`` (node decisions bit-identical
    to the legacy re-solve at every grid node on the default NumPy
    backend)."""
    return build_surfaces(
        cost_model, protocols, (n_devices,), pt_scale=pt_scale,
        loss_p=loss_p, solver=solver, backend=backend,
        beam_width=beam_width, chunk_candidates=chunk_candidates,
        energy_budget=energy_budget, variants=variants,
        accuracy_floor=accuracy_floor, device=device, dtype=dtype,
    )[n_devices]


def _resolve_axes(
    base: LinkProfile,
    pt_scale: Sequence[float],
    loss_p: Sequence[float | None] | None,
) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """One protocol's resolved (packet-time, loss) axes — the SINGLE
    source of the scale→axis mapping, shared by surface construction
    and the async rebuilder's envelope prediction
    (:meth:`repro_torch.core.async_replan.RebuildRequest.covers` must agree
    with what ``build_surfaces`` will actually build).

    The packet-time axis minimum is the refit saturation floor
    (loss-free serialization + propagation): :func:`refit_link` maps
    every packet time at or below it to the identical link, so
    estimates that run FASTER than the loss-inflated nominal stay on
    the surface (clamped exactly) instead of forcing re-solve
    fallbacks. ``None`` loss entries resolve to the protocol's base
    loss (the :meth:`ScenarioGrid.link_variant
    <repro_torch.core.sweep.ScenarioGrid.link_variant>` convention)."""
    floor = base.mtu_bytes / base.rate_bytes_per_s + base.t_prop_s
    pts = tuple(sorted({base.packet_time_s() * s for s in pt_scale}
                       | {floor}))
    losses = tuple(sorted(
        {base.loss_p} if loss_p is None
        else {base.loss_p if lp is None else lp for lp in loss_p}))
    return pts, losses


def build_surfaces(
    cost_model: SplitCostModel,
    protocols: Mapping[str, LinkProfile],
    n_devices: Sequence[int],
    pt_scale: Sequence[float] = DEFAULT_PT_SCALES,
    loss_p: Sequence[float | None] | None = DEFAULT_LOSS_GRID,
    solver: str = "batched_beam",
    backend: str | None = None,
    beam_width: int = 8,
    chunk_candidates: Sequence[int] | None = None,
    energy_budget: float | None = None,
    variants: Sequence[BottleneckVariant] | None = None,
    accuracy_floor: float | None = None,
    mesh_spec=None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> dict[int, DegradationSurface]:
    """Surface families for several fleet sizes in one batched solve (see
    :func:`_build_surfaces_impl`). In the reference a shim over the
    planner tier; the port has none yet, so this calls the impl directly
    with the fleet sizes as a tuple of ``int``, as the reference's spec
    builder passes them."""
    return _build_surfaces_impl(
        cost_model, protocols, tuple(int(n) for n in n_devices),
        pt_scale=pt_scale, loss_p=loss_p, solver=solver, backend=backend,
        beam_width=beam_width, chunk_candidates=chunk_candidates,
        energy_budget=energy_budget, variants=variants,
        accuracy_floor=accuracy_floor, mesh_spec=mesh_spec, device=device,
        dtype=dtype)


def _build_surfaces_impl(
    cost_model: SplitCostModel,
    protocols: Mapping[str, LinkProfile],
    n_devices: Sequence[int],
    pt_scale: Sequence[float] = DEFAULT_PT_SCALES,
    loss_p: Sequence[float | None] | None = DEFAULT_LOSS_GRID,
    solver: str = "batched_beam",
    backend: str | None = None,
    beam_width: int = 8,
    chunk_candidates: Sequence[int] | None = None,
    energy_budget: float | None = None,
    variants: Sequence[BottleneckVariant] | None = None,
    accuracy_floor: float | None = None,
    mesh_spec=None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> dict[int, DegradationSurface]:
    """Precompute surfaces for SEVERAL fleet sizes in one batched solve.

    The multi-N entry point behind :func:`build_surface` (which requests
    one size): all (protocol × packet-time × loss) nodes of ALL
    requested fleet sizes are solved in a single batched solver pass —
    the all-k DP table answers every size at once for
    ``solver="batched_dp"``, and for beam/greedy the fleet-size axis
    folds into the scenario axis with a per-scenario ``n_devices``
    vector (see :func:`repro_torch.core.sweep.batched_beam_search_all_k`).
    There is no per-N re-solve loop on any solver path.

    Every returned surface is node-for-node identical to calling
    :func:`build_surface` with that single fleet size (the property
    suite asserts exact ``==``). ``build_time_s``/``solve_time_s`` on
    each surface record the SHARED family build (one pass), not a
    per-size cost. ``backend`` selects the DP backend (``"cuda"`` /
    ``"torch"`` for ``solver="batched_dp"`` only — see
    :func:`build_surface` for the parity caveat; an unbudgeted ``"cuda"``
    build hands the fused kernel ``local`` + ``TX`` and never ships the
    stacked tensor to the card). Args otherwise as in
    :func:`build_surface`.

    With a ``variants`` bank the node axis grows variant-major —
    ``TX`` stacks one block of node rows per bank entry, every solver
    path (the fused kernel included) prices the folded batch untouched, and
    the per-(fleet-size, node) winner is the argmin over the bank
    (:func:`repro_torch.core.sweep._fold_variant_axis`, the same
    lowest-index tie-break as every other joint solve)."""
    backend = SW._resolve_backend(solver, backend)
    SW._refuse_mesh(mesh_spec)
    if backend in ("cuda", "torch"):
        device, dtype = resolve_device(device), resolve_dtype(dtype)
    sizes = tuple(n_devices)
    if not sizes:
        raise ValueError("n_devices must name at least one fleet size")
    if len(set(sizes)) != len(sizes):
        raise ValueError(f"n_devices has duplicates: {sizes}")
    for n in sizes:
        if n < 1:
            raise ValueError(f"fleet size must be >= 1, got {n}")
    bank = tuple(variants) if variants is not None else None
    if bank is not None and not bank:
        raise ValueError("variants bank must not be empty")
    if accuracy_floor is not None and bank is None:
        raise ValueError("accuracy_floor requires a variants bank")
    n_max = max(sizes)
    t0 = time.perf_counter()
    combine = "max" if cost_model.objective == "bottleneck" else "sum"
    # link-independent device-local tensor at the largest size; smaller
    # fleets are prefixes (device k's matrix does not depend on N).
    # Bottleneck variants never touch it — a variant reprices only the
    # cut, so the bank folds entirely into the TX rows below.
    local = cost_model.local_cost_tensor(n_max)

    # node enumeration: protocol-major, then packet time, then loss
    axes: dict[str, tuple[tuple[float, ...], tuple[float, ...]]] = {}
    links: list[LinkProfile] = []
    for name, base in protocols.items():
        pts, losses = _resolve_axes(base, pt_scale, loss_p)
        axes[name] = (pts, losses)
        for pt in pts:
            for lp in losses:
                links.append(refit_link(base, pt, lp))
    n_nodes_total = len(links)

    # with a variant bank the node axis grows variant-major: one block
    # of TX rows per bank entry (folded index v * n_nodes + node)
    node_models = ([cost_model] if bank is None
                   else [replace(cost_model, variant=v) for v in bank])
    TX = np.stack([
        replace(m, link=lk).transmission_cost_vector()
        for m in node_models
        for lk in links
    ])  # (V * S, L); plain (S, L) without a bank
    if accuracy_floor is not None:
        # mask below-floor variants in the TX rows (not just C): +inf
        # rows make every segment of the variant block infeasible on
        # EVERY solve path, the fused kernel — which consumes TX
        # directly — included. Same strict comparison as
        # :func:`repro_torch.core.sweep.apply_accuracy_floor`.
        acc = np.array([v.accuracy_proxy for v in bank])
        floor_mask = acc < float(accuracy_floor)
        if floor_mask.any():
            TX = np.where(
                np.repeat(floor_mask, n_nodes_total)[:, None], INF, TX)
    C = local[None, :, :, :] + TX[:, None, None, :]
    if energy_budget is not None:
        # per-node energy tensors (each node's own re-fitted link, each
        # variant's own encoder Joules) mask over-budget segments to
        # +inf; the DP then minimizes latency subject to the budget on
        # every backend
        E = np.stack([
            replace(m, link=lk).energy_cost_tensor(n_max)
            for m in node_models
            for lk in links
        ])
        C = SW.apply_energy_budget(C, E, energy_budget)
    kwargs = {"beam_width": beam_width} if solver == "batched_beam" else {}

    # ONE batched pass answers every requested fleet size
    res_by_n: dict[int, SW.BatchedSolverResult]
    if solver == "batched_dp":
        # all-k trick: the DP table at device k IS the k-device answer
        # (on every backend: the kernels return the whole per-device
        # table stack)
        if backend == "cuda" and energy_budget is None:
            # fused kernel: the solve consumes (local, TX) directly and
            # never ships C to the card (the host-side C above only
            # prices assembled nodes / chunk tuning). Budgeted runs
            # take the dense kernel below — the fused kernel prices
            # raw local + TX and cannot see the energy mask.
            from repro_torch.core import cuda_dp

            all_k = cuda_dp.cuda_fused_optimal_dp(
                local, None, TX, combine=combine, return_all_k=True,
                device=device, dtype=dtype)
        else:
            all_k = SW.batched_optimal_dp(C, combine=combine,
                                          backend=backend,
                                          return_all_k=True,
                                          device=device, dtype=dtype)
        res_by_n = {n: all_k[n] for n in sizes}
        solve_time = all_k[n_max].wall_time_s
    elif solver == "batched_beam":
        # all-k beam: fleet sizes as blocks over the shared tensor
        res_by_n = SW.batched_beam_search_all_k(
            C, combine=combine, fleet_sizes=sizes, **kwargs)
        solve_time = res_by_n[n_max].wall_time_s
    else:
        # all-k greedy: same block construction as the beam
        res_by_n = SW.batched_greedy_search_all_k(
            C, combine=combine, fleet_sizes=sizes, **kwargs)
        solve_time = res_by_n[n_max].wall_time_s

    C_by_n: dict[int, np.ndarray] = {}
    if bank is not None and len(bank) > 1:
        # collapse the variant-major fold per fleet size: different
        # fleet sizes may adopt different variants at the same node, so
        # each size gets its own winner rows (and the winning variant's
        # C rows for runner-up portfolio scoring)
        for n in sizes:
            folded, win_rows = SW._fold_variant_axis(
                res_by_n[n], len(bank), n_nodes_total)
            res_by_n[n] = folded
            C_by_n[n] = C[win_rows]

    assembled = {
        n: _assemble_protocol_surfaces(
            cost_model, protocols, axes, links, C_by_n.get(n, C),
            res_by_n[n], n, combine, chunk_candidates, variants=bank)
        for n in sizes
    }
    # shared family wall: every surface reports the one batched build
    wall = time.perf_counter() - t0
    return {
        n: DegradationSurface(
            protocols=assembled[n], n_devices=n, solver=solver,
            build_time_s=wall, solve_time_s=solve_time,
        )
        for n in sizes
    }


def _assemble_protocol_surfaces(
    cost_model: SplitCostModel,
    protocols: Mapping[str, LinkProfile],
    axes: Mapping[str, tuple[tuple[float, ...], tuple[float, ...]]],
    links: Sequence[LinkProfile],
    C: np.ndarray,
    res: "SW.BatchedSolverResult",
    n_devices: int,
    combine: str,
    chunk_candidates: Sequence[int] | None,
    variants: Sequence[BottleneckVariant] | None = None,
) -> dict[str, ProtocolSurface]:
    """Per-node pricing for one fleet size: chunk-tune and price each
    node's winning plan (the legacy adoption arithmetic, so node
    decisions stay bit-identical to a re-solve) and pick its runner-up
    from the protocol's plan portfolio. With a ``variants`` bank the
    node's winning variant model prices everything — chunk tuning sees
    the compressed cut bytes, latency includes the encoder cost, and
    the node records the winning bank index."""
    bank_models = (None if variants is None
                   else [replace(cost_model, variant=v) for v in variants])

    def node_model(vi: int) -> SplitCostModel:
        return cost_model if bank_models is None else bank_models[vi]

    def tuned_latency(lk: LinkProfile, splits: tuple[int, ...],
                      model: SplitCostModel) -> tuple[int, float]:
        """Chunk-tune a plan and price it — the legacy adoption
        arithmetic, on the node's winning variant model (compressed cut
        bytes drive the chunk choice)."""
        cuts = [model.cut_payload_bytes(b) for b in splits]
        chunk, _ = optimize_chunk_size(lk, cuts, chunk_candidates)
        tuned = replace(lk, mtu_bytes=chunk)
        lat = replace(model, link=tuned).end_to_end_s(splits)
        return chunk, lat

    surfaces: dict[str, ProtocolSurface] = {}
    s = 0
    for name, base in protocols.items():
        pts, losses = axes[name]
        T, G = len(pts), len(losses)
        n_nodes = T * G
        node_links = links[s:s + n_nodes]
        node_res_lo = s
        splits = np.full((T, G, max(n_devices - 1, 0)), -1, dtype=np.int64)
        chunks = np.zeros((T, G), dtype=np.int64)
        lats = np.full((T, G), INF)
        run_splits = np.full_like(splits, -1)
        run_lats = np.full((T, G), INF)
        var_grid = (None if variants is None
                    else np.zeros((T, G), dtype=np.int64))

        # plan portfolio: the distinct feasible plans across this
        # protocol's nodes, scored on every node in one batched pass —
        # the per-node runner-up comes from this portfolio
        portfolio: list[tuple[int, ...]] = []
        seen: set[tuple[int, ...]] = set()
        for g in range(n_nodes):
            sp = res.splits_tuple(node_res_lo + g)
            if (sp or n_devices == 1) and bool(res.feasible[node_res_lo + g]):
                if sp not in seen:
                    seen.add(sp)
                    portfolio.append(sp)
        port_cost = None
        if len(portfolio) >= 2 and n_devices > 1:
            cand = np.array(portfolio, dtype=np.int64)  # (M, n-1)
            port_cost = SW.batched_total_cost(
                C[node_res_lo:node_res_lo + n_nodes, :n_devices],
                cand, combine)  # (S_g, M)

        for i in range(T):
            for j in range(G):
                g = i * G + j
                ridx = node_res_lo + g
                if not bool(res.feasible[ridx]):
                    continue
                sp = res.splits_tuple(ridx)
                if not sp and n_devices > 1:
                    continue
                lk = node_links[g]
                vi = 0
                if res.variant is not None:
                    vi = max(int(res.variant[ridx]), 0)
                if var_grid is not None:
                    var_grid[i, j] = vi
                model = node_model(vi)
                chunk, lat = tuned_latency(lk, sp, model)
                splits[i, j] = np.asarray(sp, dtype=np.int64)
                chunks[i, j] = chunk
                lats[i, j] = lat
                if port_cost is not None:
                    # runner-up: cheapest portfolio plan that is not the
                    # winner, chunk-tuned and priced like the winner
                    # (under the node's winning variant model — the
                    # variant is the node's decision, the runner-up
                    # only hedges the split)
                    order = np.argsort(port_cost[g], kind="stable")
                    for m in order:
                        alt = portfolio[int(m)]
                        if alt != sp and np.isfinite(port_cost[g, m]):
                            r_chunk, r_lat = tuned_latency(lk, alt, model)
                            run_splits[i, j] = np.asarray(alt, dtype=np.int64)
                            run_lats[i, j] = r_lat
                            break
        surfaces[name] = ProtocolSurface(
            protocol=name, base=base, packet_time_s=pts, loss_p=losses,
            splits=splits, chunk_bytes=chunks, latency_s=lats,
            runner_splits=run_splits, runner_latency_s=run_lats,
            variant=var_grid,
        )
        s += n_nodes
    return surfaces
