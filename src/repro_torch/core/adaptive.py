"""Adaptive split management — the paper's stated future work, built.

The port's counterpart of ``repro.core.adaptive``, line for line but for
the dispatch: a manager (and :func:`fleet_managers` above it) takes
``backend=None, device=None, dtype=torch.float32`` as keywords and runs
its surface build, its rebuilds and its exact re-solves on that one
triple (``backend=None`` resolves per solver as everywhere in the port:
the card for ``optimal_dp``'s twin ``batched_dp``, numpy on the host for
beam and greedy). A manager built on the card never re-solves on the
host, and the reverse.

  "Future work will build a dynamic, adaptive framework that selects
   protocols, activation chunk sizes, and split points at runtime based
   on network conditions, and device resources."  (Sec. VI)

Three pieces:

* :class:`LinkEstimator` — online EWMA estimation of per-packet time and
  loss from observed hop latencies (the runtime's view of "network
  conditions"); exposes a re-fitted :class:`LinkProfile`.

* :func:`optimize_chunk_size` — per-protocol activation chunk-size
  selection: Eq. 7 is piecewise in ceil(L/chunk), so the best chunk for a
  given split plan is NOT always the MTU when per-packet overhead is
  amortized differently across the plan's cut sizes (the Table II
  1460-vs-1200 inversion).

* :class:`AdaptiveSplitManager` — holds the current plan; every
  ``observe()`` feeds hop measurements to the estimator. The hot loop is
  an O(1) lookup into a precomputed
  :class:`~repro_torch.core.surface.DegradationSurface` (best plan + tuned
  chunk per (packet-time × loss) node, latency bilinearly interpolated
  between nodes) followed by a hysteresis check; an exact Beam-Search
  re-solve runs only when an estimate leaves the surface's precomputed
  envelope (or when no surface is configured). Hysteresis prevents plan
  thrash; every decision is recorded for audit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import solvers as S
from repro_torch.core import sweep as SW
from repro_torch.core.async_replan import SurfaceRebuilder
from repro_torch.core.latency import BottleneckVariant, LinkProfile, SplitCostModel
from repro_torch.core.planner import SplitPlan, _build_plan, plan_split, plans_from_batched
from repro_torch.core.surface import (  # noqa: F401  (optimize_chunk_size re-exported)
    DegradationSurface,
    build_surface,
    build_surfaces,
    optimize_chunk_size,
    refit_link,
)


def _batched_twin(solver: str) -> str:
    """Scalar solver name → its batched twin (identity for names that
    are already batched or have no twin). The SINGLE source of this
    mapping — shared by :meth:`AdaptiveSplitManager._batched_solver_name`
    and :func:`fleet_managers`."""
    return {"beam": "batched_beam", "optimal_dp": "batched_dp",
            "greedy": "batched_greedy"}.get(solver, solver)


def _one_backend(backend: str | None, surface_grid: dict | None) -> str | None:
    """The one backend a manager or a fleet solves everything on:
    ``backend``, or else the ``surface_grid``'s ``"backend"`` entry,
    which must not name another."""
    grid_backend = (surface_grid or {}).get("backend")
    if grid_backend is not None and backend is not None \
            and grid_backend != backend:
        raise ValueError(
            f"backend={backend!r} but surface_grid names backend "
            f"{grid_backend!r}: surfaces, rebuilds and re-solves run on "
            f"one backend")
    return backend if backend is not None else grid_backend


class LinkEstimator:
    """EWMA estimate of a link's effective per-packet time and loss.

    ``loss_warmup`` seeds the loss EWMA with that many *virtual prior
    observations*: the effective step size ramps from
    ``alpha/(1+loss_warmup)`` up to ``alpha`` as real observations
    accumulate, so one lucky retry-free hop early in the run cannot
    erase a calibrated loss prior (it used to decay the prior by a full
    ``alpha`` fraction on the very first observation)."""

    def __init__(self, base: LinkProfile, alpha: float = 0.2,
                 loss_warmup: int = 5):
        self.base = base
        self.alpha = alpha
        self.loss_warmup = loss_warmup
        self._packet_time_s = base.packet_time_s()
        self._loss = base.loss_p
        self.n_obs = 0

    @property
    def packet_time_estimate(self) -> float:
        """Current per-packet-time estimate (the surface's first axis)."""
        return self._packet_time_s

    @property
    def loss_estimate(self) -> float:
        """Current loss estimate (the surface's second axis)."""
        return self._loss

    def observe_hop(self, nbytes: int, latency_s: float, retries: int = 0):
        """One observed transfer: ``nbytes`` took ``latency_s`` with
        ``retries`` retransmissions."""
        k = max(1, self.base.packets(nbytes))
        per_packet = latency_s / k
        self._packet_time_s = (1 - self.alpha) * self._packet_time_s \
            + self.alpha * per_packet
        obs_loss = retries / (k + retries) if retries else 0.0
        # warm-up-damped step: the prior counts as `loss_warmup` virtual
        # observations until enough real ones accumulate
        a = self.alpha * (self.n_obs + 1) / (self.n_obs + 1 + self.loss_warmup)
        self._loss = (1 - a) * self._loss + a * obs_loss
        self.n_obs += 1

    def current_profile(self) -> LinkProfile:
        """The base profile re-fitted to the observed per-packet time.
        The serialization term keeps the base rate; the residual moves
        into the ack/overhead term (and the loss estimate). Shared with
        surface construction via :func:`repro_torch.core.surface.refit_link`
        so surface nodes reproduce this mapping bit-for-bit."""
        return refit_link(self.base, self._packet_time_s, self._loss)


@dataclass
class PlanDecision:
    step: int
    protocol: str
    chunk_bytes: int
    splits: tuple[int, ...]
    predicted_latency_s: float
    reason: str
    # index into the manager's bottleneck-variant bank (0 = the bank's
    # first entry, and also the value when no bank is configured)
    variant: int = 0


@dataclass
class AdaptiveSplitManager:
    """Runtime re-planning over (protocol x chunk size x split points).

    ``surface`` controls the ``observe()`` hot path:

    * ``"auto"`` (default) — precompute a
      :class:`~repro_torch.core.surface.DegradationSurface` at construction;
      ``observe()`` is then a surface lookup + hysteresis check, with an
      exact re-solve only when an estimate leaves the surface envelope.
    * a prebuilt :class:`DegradationSurface` — use it as-is.
    * ``None`` — legacy behavior: a full batched re-solve on every
      ``observe()`` (the benchmark baseline).

    ``async_rebuild`` controls what happens when estimates leave the
    surface envelope (requires a surface — raises otherwise):

    * ``False``/``None`` (default) — synchronous behavior: every
      out-of-envelope ``observe()`` blocks on an exact batched re-solve
      and the surface is never rebuilt.
    * ``True`` — stale-while-revalidate: drift enqueues a re-centered
      surface rebuild on a background
      :class:`~repro_torch.core.async_replan.SurfaceRebuilder` (single worker
      thread) while ``observe()`` keeps serving from the stale surface;
      the exact re-solve runs only when the estimate has moved
      materially (``stale_rtol``/``stale_loss_tol``) since the last
      one, bounding the in-flight fallback cost. The rebuilt surface is
      swapped in atomically on a later ``observe()``
      (``surface_swaps`` counts adoptions, ``rebuild_requests`` the
      drift triggers, ``stale_serves`` the observes answered from the
      stale decision while a rebuild was pending).
    * an executor (anything with ``submit(fn)``, e.g.
      :class:`~repro_torch.core.async_replan.ManualExecutor`) — as ``True``
      but builds run on the injected executor (deterministic tests).
    * a prebuilt :class:`~repro_torch.core.async_replan.SurfaceRebuilder` —
      share one rebuilder across managers; a whole fleet's drifted
      scenarios then batch into ONE multi-size solve per cycle (see
      :func:`fleet_managers`).

    ``backend`` / ``device`` / ``dtype`` (keywords) say where the
    surface build, the rebuilds and the exact re-solves run, all three
    alike; ``backend=None`` takes a ``"backend"`` entry of
    ``surface_grid`` when there is one (:func:`_one_backend`).
    """

    cost_model: SplitCostModel  # device/profile side (protocol swapped in)
    protocols: dict[str, LinkProfile]
    n_devices: int
    replan_threshold: float = 0.10  # re-plan when >10% better is available
    solver: str = "beam"
    surface: DegradationSurface | str | None = "auto"
    # extra kwargs for build_surface (axes, chunk candidates, ...); a
    # "backend" entry here is the manager's one backend (see backend)
    surface_grid: dict | None = None
    # async out-of-envelope handling: False/None (sync re-solve), True
    # (background thread), an executor with submit(), a shared
    # SurfaceRebuilder, or any rebuilder-like object with
    # request()/poll() (e.g. a RebuildHandle view of a shared fanout) —
    # see the class docstring
    async_rebuild: object | bool | None = None
    # staleness window for the in-flight fallback: the exact re-solve
    # repeats only when the estimate moved more than this since the
    # last one (relative on packet time, absolute on loss)
    stale_rtol: float = 0.10
    stale_loss_tol: float = 0.02
    # how the FIRST decision is made: "resolve" (exact batched solve —
    # the certified default) or "surface" (O(1) lookup on the prebuilt
    # surface at the base estimator state; falls back to the exact
    # solve when no surface hit exists). "surface" is what lets a
    # gateway register thousands of sessions without one full solve
    # per registration.
    initial: str = "resolve"
    # out-of-envelope policy when a rebuilder is attached: "exact"
    # (bounded inline re-solves) or "stale" (NEVER
    # re-solve inline once a decision exists — request a rebuild and
    # keep serving the stale decision until the swap; the only inline
    # solve left is the bootstrap when no decision exists yet)
    offsurface_fallback: str = "exact"
    # injected link-independent device-local cost tensor (shared across
    # a fleet of same-size managers); None = build lazily per manager
    local_tensor: object | None = None
    # optional per-device Joule cap: every re-plan (batched or scalar)
    # masks over-budget segments to +inf, so decisions minimize latency
    # subject to the budget (see repro_torch.core.sweep.apply_energy_budget)
    energy_budget: float | None = None
    # optional bottleneck-variant bank: every re-plan (surface, batched,
    # or scalar) then decides (split, variant) jointly, the adopted
    # decision records the winning bank index, and all pricing — chunk
    # tuning, hysteresis, the fast path — runs on the winning variant's
    # compressed cut bytes + encoder cost
    variants: Sequence[BottleneckVariant] | None = None
    # with a bank: mask entries whose accuracy_proxy is below the floor
    # before every solve (min latency s.t. accuracy >= floor)
    accuracy_floor: float | None = None
    history: list[PlanDecision] = field(default_factory=list)
    # the port's dispatch: where surfaces, rebuilds and re-solves run
    backend: str | None = field(default=None, kw_only=True)
    device: object = field(default=None, kw_only=True)
    dtype: torch.dtype = field(default=torch.float32, kw_only=True)

    def __post_init__(self):
        self.backend = _one_backend(self.backend, self.surface_grid)
        L = self.cost_model.profile.num_layers
        if not 1 <= self.n_devices <= L:
            raise ValueError(f"n_devices={self.n_devices} out of range for L={L}")
        if self.variants is not None:
            self.variants = tuple(self.variants)
            if not self.variants:
                raise ValueError("variants bank must not be empty")
        if self.accuracy_floor is not None and self.variants is None:
            raise ValueError("accuracy_floor requires a variants bank")
        self.estimators = {name: LinkEstimator(link)
                           for name, link in self.protocols.items()}
        self._step = 0
        self._local_tensor = None  # built lazily; link-independent
        self._fast = None  # precomputed current-plan latency coefficients
        self.surface_hits = 0
        self.exact_fallbacks = 0
        if self.surface == "auto":
            batched = self._batched_solver_name()
            if batched in SW.BATCHED_SOLVERS:
                from repro_torch.core.spec import PlannerService

                self.surface = PlannerService(self.device, self.dtype) \
                    .build_surfaces(self.surface_spec())[self.n_devices]
            else:
                # scalar-only solvers (first_fit, random_fit, ...) have no
                # batched twin to precompute with: keep the legacy
                # re-solve-per-observe path instead of refusing to start
                self.surface = None
        if self.initial not in ("resolve", "surface"):
            raise ValueError(f"initial must be 'resolve' or 'surface', "
                             f"got {self.initial!r}")
        if self.offsurface_fallback not in ("exact", "stale"):
            raise ValueError(f"offsurface_fallback must be 'exact' or "
                             f"'stale', got {self.offsurface_fallback!r}")
        self.rebuild_requests = 0
        self.surface_swaps = 0
        self.stale_serves = 0
        self._rebuilder = None
        self._fallback_state: dict[str, tuple[float, float]] | None = None
        if self.async_rebuild:
            if self.surface is None:
                raise ValueError(
                    f"async_rebuild needs a degradation surface to "
                    f"revalidate; solver {self.solver!r} has no batched "
                    f"twin (or surface=None was forced)")
            if self._is_rebuilder_like(self.async_rebuild):
                self._rebuilder = self.async_rebuild
            else:
                rebuild_kwargs = dict(self.surface_grid or {})
                rebuild_kwargs["backend"] = self.backend
                rebuild_kwargs.setdefault("energy_budget", self.energy_budget)
                rebuild_kwargs.setdefault("variants", self.variants)
                rebuild_kwargs.setdefault("accuracy_floor", self.accuracy_floor)
                self._rebuilder = SurfaceRebuilder(
                    self.cost_model, self.protocols,
                    solver=self._batched_solver_name(),
                    executor=(None if self.async_rebuild is True
                              else self.async_rebuild),
                    device=self.device, dtype=self.dtype,
                    **rebuild_kwargs,
                )
        self.current: PlanDecision | None = None
        if self.initial == "surface" \
                and isinstance(self.surface, DegradationSurface):
            states = {name: (est.packet_time_estimate, est.loss_estimate)
                      for name, est in self.estimators.items()}
            hit = self.surface.best_lookup(states)
            if hit is not None:
                self.surface_hits += 1
                self._adopt(hit.protocol, hit.splits, hit.chunk_bytes,
                            hit.latency_s, "initial [surface]",
                            variant=hit.variant)
        if self.current is None:
            self._replan("initial")

    def surface_spec(self):
        """The :class:`~repro_torch.core.spec.PlanSpec` this manager's
        ``surface="auto"`` build resolves to: the ``surface_grid`` axes
        (defaulted like :func:`~repro_torch.core.surface.build_surface`) plus
        the manager's backend, energy budget, variant bank and accuracy
        floor. ``PlannerService(device, dtype).build_surfaces(spec)
        [self.n_devices]`` is exactly the surface the constructor adopts —
        the serializable form of this manager's planning request."""
        from repro_torch.core.spec import surfaces_spec
        from repro_torch.core.surface import DEFAULT_LOSS_GRID, DEFAULT_PT_SCALES

        grid = dict(self.surface_grid or {})
        grid["backend"] = self.backend
        grid.setdefault("energy_budget", self.energy_budget)
        grid.setdefault("variants", self.variants)
        grid.setdefault("accuracy_floor", self.accuracy_floor)
        grid.setdefault("pt_scale", DEFAULT_PT_SCALES)
        grid.setdefault("loss_p", DEFAULT_LOSS_GRID)
        return surfaces_spec(
            self.cost_model, self.protocols, (self.n_devices,),
            solver=self._batched_solver_name(), **grid)

    @staticmethod
    def _is_rebuilder_like(obj: object) -> bool:
        """Anything speaking the rebuilder protocol — ``request(n,
        states)`` + ``poll(n)`` — is wired directly (a shared
        :class:`SurfaceRebuilder`, or a
        :class:`~repro_torch.core.async_replan.RebuildHandle` view of a shared
        fanout). Executors only have ``submit``."""
        return callable(getattr(obj, "request", None)) \
            and callable(getattr(obj, "poll", None))

    # -- runtime feedback ------------------------------------------------------
    def observe(self, protocol: str, nbytes: int, latency_s: float,
                retries: int = 0):
        """Feed one observed hop; may trigger a re-plan.

        With a surface this is O(1): per-protocol grid lookups + one
        hysteresis comparison. The solver only runs when an estimate
        leaves the surface envelope (``exact_fallbacks`` counts those) —
        and with ``async_rebuild`` even that is bounded: drift enqueues
        a background rebuild and the in-flight window is served from
        the stale decision (``stale_serves``) unless the estimate keeps
        moving materially."""
        self._step += 1
        self.estimators[protocol].observe_hop(nbytes, latency_s, retries)
        if self._rebuilder is not None:
            self._adopt_ready_surface()
        if self.surface is None:
            self._observe_resolve()
            return
        # single-sourced on the estimate accessors — the SAME view
        # _observe_resolve prices via current_profile(); building states
        # from the raw EWMA fields here once let the envelope lookup and
        # the re-solve disagree during the loss warm-up window
        states = {name: (est.packet_time_estimate, est.loss_estimate)
                  for name, est in self.estimators.items()}
        hit = self.surface.best_lookup(states)
        if hit is None:  # outside the envelope (or nothing feasible on it)
            self._observe_off_surface(states)
            return
        self.surface_hits += 1
        if self._fallback_state is not None:
            self._fallback_state = None  # back inside: next drift re-solves
        if self.current is None:
            self._adopt(hit.protocol, hit.splits, hit.chunk_bytes,
                        hit.latency_s, "initial", variant=hit.variant)
            return
        cur = self.current
        if (hit.protocol == cur.protocol and hit.splits == cur.splits
                and hit.chunk_bytes == cur.chunk_bytes
                and hit.variant == cur.variant):
            # already on the surface's decision: nothing to adopt (and the
            # interpolated latency may disagree with the exact current-plan
            # estimate mid-cell, which must not re-record the same plan)
            return
        pt, lp = states[cur.protocol]
        cur_lat = self._fast_current_latency(pt, lp)
        if hit.latency_s < cur_lat * (1 - self.replan_threshold):
            self._adopt(hit.protocol, hit.splits, hit.chunk_bytes,
                        hit.latency_s,
                        f"estimated {cur_lat:.3f}s -> {hit.latency_s:.3f}s "
                        f"available", variant=hit.variant)

    def _observe_off_surface(self, states: dict[str, tuple[float, float]]):
        """An estimate left the surface envelope. Synchronous mode: exact
        re-solve every time. Async mode (stale-while-revalidate): enqueue
        a re-centered rebuild on material movement and otherwise keep
        serving the current (stale) decision — the exact re-solve runs
        once per material drift step, not once per observe."""
        if self._rebuilder is not None:
            moved = self._states_moved(states)
            if moved:
                self.rebuild_requests += 1
                self._rebuilder.request(self.n_devices, states)
            if self.offsurface_fallback == "stale":
                # never re-solve inline once a decision exists: the
                # drift was requested above (debounced by the staleness
                # window) and the stale decision keeps serving until
                # the rebuilt surface swaps in
                if moved:
                    self._fallback_state = dict(states)
                if self.current is not None:
                    self.stale_serves += 1
                    return
            elif not moved:
                if self.current is not None:
                    self.stale_serves += 1
                    return
        self.exact_fallbacks += 1
        self._observe_resolve(reason_suffix=" [envelope re-solve]")
        self._fallback_state = dict(states)

    def _states_moved(self, states: dict[str, tuple[float, float]]) -> bool:
        """Has any estimate moved materially since the last exact
        fallback re-solve? (The staleness window: within it, the stale
        decision keeps serving.)"""
        prev = self._fallback_state
        if prev is None:
            return True
        for name, (pt, lp) in states.items():
            pt0, lp0 = prev[name]
            if abs(pt - pt0) > self.stale_rtol * pt0 \
                    or abs(lp - lp0) > self.stale_loss_tol:
                return True
        return False

    def _adopt_ready_surface(self):
        """Atomic swap-on-ready: if the rebuilder finished a NEWER
        surface for this fleet size, adopt it (one reference swap) and
        reset the staleness window. A rebuild FAILURE also resets the
        window before propagating — otherwise a settled estimate would
        sit inside the staleness tolerance forever and the failed
        rebuild would never be re-requested."""
        try:
            ready = self._rebuilder.poll(self.n_devices)
        except Exception:
            self._fallback_state = None  # next drifted observe re-requests
            raise
        if ready is not None:
            self.surface = ready
            self.surface_swaps += 1
            self._fallback_state = None

    @property
    def rebuilder(self):
        """The async rebuilder in use (None in synchronous mode). For a
        fleet this is the SHARED rebuilder (or a per-session
        :class:`~repro_torch.core.async_replan.RebuildHandle` view of it) —
        shut the shared one down once when the fleet retires."""
        return self._rebuilder

    def counters(self) -> dict[str, int]:
        """Snapshot of the adaptive-path counters (plain ints — safe to
        aggregate across a fleet)."""
        return {
            "surface_hits": self.surface_hits,
            "exact_fallbacks": self.exact_fallbacks,
            "rebuild_requests": self.rebuild_requests,
            "surface_swaps": self.surface_swaps,
            "stale_serves": self.stale_serves,
            "replans": len(self.history),
        }

    def close(self):
        """Release the background rebuild executor this manager created
        (``async_rebuild=True`` or an injected executor). A SHARED
        rebuilder-like object (a ``SurfaceRebuilder`` or a
        ``RebuildHandle``) is left running — its owner closes it
        (``RebuildHandle.shutdown`` is a no-op anyway). Safe to call
        repeatedly; the manager keeps serving from its current surface
        afterwards."""
        if self._rebuilder is not None \
                and not self._is_rebuilder_like(self.async_rebuild):
            self._rebuilder.shutdown()

    def _observe_resolve(self, reason_suffix: str = ""):
        """The legacy per-observe path: full batched re-solve."""
        best_name, best_splits, best_chunk, best_lat, best_vi = \
            self._best_available()
        if best_name is None:
            return
        if self.current is None:
            self._adopt(best_name, best_splits, best_chunk, best_lat,
                        "initial", variant=best_vi)
            return
        cur_lat = self._current_latency_under_estimates()
        if best_lat < cur_lat * (1 - self.replan_threshold):
            self._adopt(best_name, best_splits, best_chunk, best_lat,
                        f"estimated {cur_lat:.3f}s -> {best_lat:.3f}s "
                        f"available{reason_suffix}", variant=best_vi)

    # -- internals ---------------------------------------------------------------
    def _batched_solver_name(self) -> str:
        return _batched_twin(self.solver)

    def _model_for(self, link: LinkProfile) -> SplitCostModel:
        return replace(self.cost_model, link=link)

    def _ensure_local_tensor(self) -> np.ndarray:
        if self._local_tensor is None:
            if self.local_tensor is not None:  # fleet-shared injection
                self._local_tensor = self.local_tensor
            else:
                self._local_tensor = \
                    self.cost_model.local_cost_tensor(self.n_devices)
        return self._local_tensor

    def _batched_plans(self, links, solver: str) -> list[SplitPlan]:
        """One batched solve across all protocols, reusing the
        link-independent device-local tensor (built once per manager —
        the bank never touches it: a variant reprices only the cut, so
        with ``variants`` the scenario axis just grows variant-major,
        exactly like surface construction, and folds back per link). The
        solve runs on the manager's backend, device and dtype."""
        local = self._ensure_local_tensor()
        models = [self._model_for(lk) for lk in links]
        bank = self.variants
        if bank is None:
            node_models = models
        else:
            node_models = [replace(m, variant=v) for v in bank for m in models]
        TX = np.stack([m.transmission_cost_vector() for m in node_models])
        if self.accuracy_floor is not None:
            # same TX-row masking as build_surfaces: +inf rows knock the
            # below-floor variant blocks out on every solve path
            acc = np.array([v.accuracy_proxy for v in bank])
            floor_mask = acc < float(self.accuracy_floor)
            if floor_mask.any():
                TX = np.where(
                    np.repeat(floor_mask, len(models))[:, None],
                    float("inf"), TX)
        C = local[None, :, :, :] + TX[:, None, None, :]
        if self.energy_budget is not None:
            E = np.stack([m.energy_cost_tensor(self.n_devices)
                          for m in node_models])
            C = SW.apply_energy_budget(C, E, self.energy_budget)
        combine = "max" if self.cost_model.objective == "bottleneck" else "sum"
        res = SW.solve_batched(C, solver=solver, combine=combine,
                               backend=self.backend, device=self.device,
                               dtype=self.dtype)
        if bank is not None and len(bank) > 1:
            res, _ = SW._fold_variant_axis(res, len(bank), len(models))
        elif bank is not None:
            res = replace(res, variant=np.where(
                res.feasible, 0, -1).astype(np.int64))
        return plans_from_batched(models, res, self.n_devices,
                                  variants=bank)

    def _variant_model(self, model: SplitCostModel,
                       vi: int | None) -> SplitCostModel:
        """``model`` carrying bank entry ``vi`` (unchanged without a
        bank or for sentinel/identity indices — the historical object)."""
        if self.variants is None or vi is None or vi < 0:
            return model
        return replace(model, variant=self.variants[vi])

    def _best_available(self):
        """Re-plan every protocol in ONE batched tensor pass (the sweep
        engine), then tune each winner's activation chunk size. This is
        the exact path the degradation surface precomputes; at surface
        grid nodes both produce identical decisions. With a variant
        bank each plan arrives on its winning variant's model, so the
        cut bytes driving chunk tuning are compressed and the priced
        latency includes the encoder cost."""
        best = (None, (), 0, float("inf"), 0)
        names = list(self.estimators.keys())
        links = [self.estimators[n].current_profile() for n in names]
        solver = self._batched_solver_name()
        if solver in ("batched_beam", "batched_dp", "batched_greedy"):
            plans = self._batched_plans(links, solver)
        else:  # fall back to the scalar oracle path
            plans = [plan_split(self._model_for(lk), self.n_devices,
                                solver=self.solver,
                                energy_budget=self.energy_budget,
                                variants=self.variants,
                                accuracy_floor=self.accuracy_floor)
                     for lk in links]
        for name, link, plan in zip(names, links, plans):
            if not plan.splits and self.n_devices > 1:
                continue
            cuts = [seg.tx_bytes for seg in plan.segments[:-1]]
            chunk, _ = optimize_chunk_size(link, cuts)
            tuned = replace(link, mtu_bytes=chunk)
            vi = plan.variant if plan.variant is not None else 0
            lat = self._variant_model(self._model_for(tuned),
                                      plan.variant).end_to_end_s(plan.splits)
            if lat < best[3]:
                best = (name, plan.splits, chunk, lat, max(vi, 0))
        return best

    def _current_latency_under_estimates(self) -> float:
        cur = self.current
        link = self.estimators[cur.protocol].current_profile()
        tuned = replace(link, mtu_bytes=cur.chunk_bytes)
        return self._variant_model(self._model_for(tuned),
                                   cur.variant).end_to_end_s(cur.splits)

    def _fast_current_latency(self, packet_time_s: float, loss: float) -> float:
        """The current plan's latency under estimator state
        ``(packet_time_s, loss)`` from precomputed coefficients —
        bit-identical to :meth:`_current_latency_under_estimates` (same
        refit clamps, same float operation order as ``end_to_end_s``)
        without rebuilding links, models, or segment sums per observe."""
        f = self._fast
        if f is None:
            return self._current_latency_under_estimates()
        serial = f["mtu"] / (f["rate"] * (1.0 - max(loss, 0.0)))
        t_ack = max(0.0, packet_time_s - serial - f["t_prop"])
        ptime = (f["chunk"] / (f["rate"] * (1.0 - min(loss, 0.9)))
                 + f["t_prop"] + t_ack)
        locs, Ks, encs = f["locs"], f["Ks"], f["encs"]
        segs = []
        for i, loc in enumerate(locs):
            if i < len(Ks):
                tx = Ks[i] * ptime
                if f["include_setup"]:
                    tx += f["setup"]
                if encs is not None:
                    # variant encoder cost: added after setup, matching
                    # SplitCostModel.segment_cost_s float op order
                    tx += encs[i]
                segs.append(loc + tx)
            else:
                segs.append(loc)
        total = max(segs) if f["bottleneck"] else sum(segs)
        total += f["setup"] + f["feedback"]
        return total

    def _prime_fast_path(self):
        """Precompute the current plan's latency coefficients: per-device
        local costs (from the bit-exact local tensor), per-cut packet
        counts under the adopted chunk size (of the adopted variant's
        COMPRESSED payload), and the variant's per-cut encoder times
        (``None`` without an active variant, keeping the historical
        coefficient set byte-for-byte)."""
        cur = self.current
        base = self.protocols[cur.protocol]
        prof = self.cost_model.profile
        vmodel = self._variant_model(self.cost_model, cur.variant)
        v = vmodel._active_variant
        L = prof.num_layers
        local = self._ensure_local_tensor()
        bounds = [0, *cur.splits, L]
        locs = [float(local[i, bounds[i], bounds[i + 1] - 1])
                for i in range(len(bounds) - 1)]
        Ks = []
        encs = None if v is None else []
        for b in cur.splits:
            payload = vmodel.cut_payload_bytes(b)
            Ks.append(math.ceil(payload / cur.chunk_bytes) if payload > 0 else 0)
            if v is not None:
                encs.append(v.encoder_time_s(prof.boundary_act_bytes(b)))
        self._fast = {
            "locs": locs, "Ks": Ks, "encs": encs, "chunk": cur.chunk_bytes,
            "mtu": base.mtu_bytes, "rate": base.rate_bytes_per_s,
            "t_prop": base.t_prop_s, "setup": base.t_setup_s,
            "feedback": base.t_feedback_s,
            "include_setup": self.cost_model.include_setup,
            "bottleneck": self.cost_model.objective == "bottleneck",
        }

    def current_plan(self) -> SplitPlan | None:
        """Materialize the current decision as a planner
        :class:`SplitPlan` (for runtime consumers like the serving
        meter's replan hook)."""
        if self.current is None:
            return None
        cur = self.current
        link = self.estimators[cur.protocol].current_profile()
        tuned = replace(link, mtu_bytes=cur.chunk_bytes)
        model = self._variant_model(self._model_for(tuned), cur.variant)
        result = S.SolverResult(
            solver="surface" if self.surface is not None else self.solver,
            splits=cur.splits,
            cost_s=model.end_to_end_s(cur.splits, with_overheads=False),
            wall_time_s=0.0, nodes_expanded=0,
            variant=None if self.variants is None else cur.variant,
        )
        return _build_plan(model, result, self.n_devices)

    def _adopt(self, name, splits: tuple[int, ...], chunk: int, lat: float,
               reason: str, variant: int = 0):
        self.current = PlanDecision(self._step, name, chunk, tuple(splits),
                                    lat, reason, variant=variant)
        self.history.append(self.current)
        self._prime_fast_path()

    def _replan(self, reason: str):
        name, splits, chunk, lat, vi = self._best_available()
        if name is not None:
            self._adopt(name, splits, chunk, lat, reason, variant=vi)


def fleet_managers(
    cost_model: SplitCostModel,
    protocols: dict[str, LinkProfile],
    n_devices: Sequence[int],
    solver: str = "beam",
    surface_grid: dict | None = None,
    async_rebuild: object | bool | None = None,
    variants: Sequence[BottleneckVariant] | None = None,
    accuracy_floor: float | None = None,
    *,
    backend: str | None = None,
    device=None,
    dtype: torch.dtype = torch.float32,
    **manager_kwargs,
) -> dict[int, AdaptiveSplitManager]:
    """Adaptive managers for a heterogeneous fleet of deployments — one
    per fleet size in ``n_devices`` — with ALL their degradation
    surfaces precomputed in ONE batched solver pass.

    Building each manager with ``surface="auto"`` would re-solve the
    whole (protocol × packet-time × loss) grid once per fleet size;
    this constructor instead calls
    :func:`repro_torch.core.surface.build_surfaces` (all-k DP / per-scenario
    fleet-size beam) and hands every manager its prebuilt surface, so a
    mixed-size deployment pays one solve. Device heterogeneity rides
    along: ``cost_model.devices`` may hold per-position profiles (device
    ``k`` of every fleet runs ``cost_model.device(k)``, as in
    :class:`~repro_torch.core.latency.SplitCostModel`).

    ``surface_grid`` passes extra axes/kwargs to ``build_surfaces``
    (like ``AdaptiveSplitManager.surface_grid``); ``manager_kwargs``
    reach each :class:`AdaptiveSplitManager` (e.g.
    ``replan_threshold``). Duplicate sizes collapse; returned dict is
    keyed by fleet size in first-seen order.

    ``async_rebuild`` (``True`` or an executor) gives the WHOLE fleet
    ONE shared :class:`~repro_torch.core.async_replan.SurfaceRebuilder`:
    every manager's drifted scenarios queue on it and each rebuild
    cycle batches all pending fleet sizes into a single multi-size
    ``build_surfaces`` solve (the same all-k pass the initial family
    build uses) — N drifting managers cost one solve, not N.

    ``variants``/``accuracy_floor`` give the whole fleet one
    bottleneck-variant bank: the shared family build, the shared
    rebuilder, and every manager's re-solve path all decide
    (split, variant) jointly from the same bank (the single-source
    guarantee — a fleet can never mix banked surfaces with unbanked
    re-solves).

    ``backend`` / ``device`` / ``dtype`` reach the family build, the
    shared rebuilder and every manager alike (a ``"backend"`` entry of
    ``surface_grid`` stands for ``backend``)."""
    sizes = tuple(dict.fromkeys(int(n) for n in n_devices))
    batched = _batched_twin(solver)
    if batched not in SW.BATCHED_SOLVERS:
        raise ValueError(
            f"solver {solver!r} has no batched twin to precompute "
            f"surfaces with; options: beam, optimal_dp, greedy, "
            f"{', '.join(sorted(SW.BATCHED_SOLVERS))}")
    grid_kwargs = dict(surface_grid or {})
    grid_kwargs["backend"] = backend = _one_backend(backend, grid_kwargs)
    grid_kwargs.setdefault("variants", variants)
    grid_kwargs.setdefault("accuracy_floor", accuracy_floor)
    surfaces = build_surfaces(cost_model, protocols, sizes,
                              solver=batched, device=device, dtype=dtype,
                              **grid_kwargs)
    rebuilder: object | bool | None = async_rebuild
    if async_rebuild and not isinstance(async_rebuild, SurfaceRebuilder):
        rebuilder = SurfaceRebuilder(
            cost_model, dict(protocols), solver=batched,
            executor=None if async_rebuild is True else async_rebuild,
            device=device, dtype=dtype, **grid_kwargs,
        )
    return {
        n: AdaptiveSplitManager(
            cost_model=cost_model, protocols=dict(protocols), n_devices=n,
            solver=solver, surface=surfaces[n], async_rebuild=rebuilder,
            variants=grid_kwargs["variants"],
            accuracy_floor=grid_kwargs["accuracy_floor"],
            backend=backend, device=device, dtype=dtype,
            **manager_kwargs)
        for n in sizes
    }


def surface_parity_report(manager: AdaptiveSplitManager) -> list[str]:
    """Node-by-node oracle-equivalence check (the acceptance contract):
    force the estimator state to every surface grid node and compare the
    exact re-solve decision (on the manager's backend, device and dtype)
    against the stored node — exact ``==`` on splits, tuned chunk, and
    latency. Empty list = parity. Estimator states are restored
    afterwards."""
    surface = manager.surface
    if not isinstance(surface, DegradationSurface):
        raise ValueError("manager has no degradation surface to certify")
    solver = manager._batched_solver_name()
    mismatches: list[str] = []
    for name, ps in surface.protocols.items():
        est = manager.estimators[name]
        saved = (est._packet_time_s, est._loss)
        for i, pt in enumerate(ps.packet_time_s):
            for j, lp in enumerate(ps.loss_p):
                est._packet_time_s = pt
                est._loss = lp
                link = est.current_profile()
                plan = manager._batched_plans([link], solver)[0]
                node = ps.node(i, j)
                if plan.splits != node.splits:
                    mismatches.append(f"{name}@({pt:.6g},{lp:g}): splits "
                                      f"{plan.splits} vs {node.splits}")
                    continue
                if not plan.splits and manager.n_devices > 1:
                    continue  # infeasible on both sides: nothing to price
                plan_vi = plan.variant if plan.variant is not None else 0
                if max(plan_vi, 0) != node.variant:
                    mismatches.append(f"{name}@({pt:.6g},{lp:g}): variant "
                                      f"{plan_vi} vs {node.variant}")
                    continue
                cuts = [seg.tx_bytes for seg in plan.segments[:-1]]
                chunk, _ = optimize_chunk_size(link, cuts)
                lat = manager._variant_model(
                    manager._model_for(replace(link, mtu_bytes=chunk)),
                    plan.variant).end_to_end_s(plan.splits)
                if chunk != node.chunk_bytes or lat != node.node_latency_s:
                    mismatches.append(
                        f"{name}@({pt:.6g},{lp:g}): chunk/lat ({chunk},{lat}) "
                        f"vs ({node.chunk_bytes},{node.node_latency_s})")
        est._packet_time_s, est._loss = saved
    return mismatches
