"""Async surface replanning — stale-while-revalidate rebuilds.

The port's counterpart of ``repro.core.async_replan``, line for line but
for the dispatch: a rebuilder takes ``backend=None, device=None,
dtype=torch.float32`` (``None`` resolves per solver as everywhere in the
port: the card for ``batched_dp``), and every build it makes — the
thread job, a process-pool job and :meth:`SurfaceRebuilder.build_sync` —
runs on that triple. A thread-built family therefore launches the DP
kernels from the executor's worker thread.

A :class:`~repro_torch.core.surface.DegradationSurface` covers a precomputed
envelope of link conditions. When an estimate drifts *outside* that
envelope the adaptive manager used to fall back to an exact batched
re-solve on EVERY ``observe()`` — correct, but the solver becomes the
hot loop again at precisely the moment the link is degrading. Rebuilding
the surface synchronously would be worse: a full (protocol ×
packet-time × loss) grid solve stalls the serving loop for the whole
build.

This module makes rebuilds *asynchronous* (stale-while-revalidate):

* :class:`SurfaceRebuilder` — a generation-versioned rebuild queue.
  Out-of-envelope estimates ``request()`` a rebuild re-centered on the
  drifted state (:func:`recentered_axes`); the build runs
  ``build_surfaces`` on a background executor while ``observe()`` keeps
  answering from the current (stale) surface, with a *bounded*
  exact-single-point fallback for the in-flight window. Triggers are
  debounced/coalesced: any number of drift events while a build is in
  flight queue at most ONE follow-up build, and a shared rebuilder
  batches every requester's fleet size into ONE multi-scenario
  ``build_surfaces`` call per cycle (the all-k solve answers them all).

* **Atomic swap-on-ready** — a completed build is adopted on the
  caller's next ``poll()``: a single reference swap, versioned by
  build generation so a stale build can never replace a newer one.
  Adoption parity is a contract: the adopted surface is the value of
  ``build_surfaces`` for the recorded :class:`RebuildRequest` — the
  SAME call a synchronous rebuild would have made — so async-adopted
  surfaces are node-identical to their synchronous twins
  (the port's tests hold them with exact ``==``).

* :class:`ManualExecutor` — a deterministic in-thread executor for
  tests and benchmarks: submitted builds queue until ``run_next()`` /
  ``run_all()``, so "while a rebuild is in flight" is an exact program
  state, not a race. The default executor is a single worker thread.

* **Out-of-process rebuilds** — pass a
  ``concurrent.futures.ProcessPoolExecutor`` as ``executor`` and the
  build leaves the serving process entirely: the request is resolved
  to a serializable :class:`~repro_torch.core.spec.PlanSpec`
  (:meth:`SurfaceRebuilder.spec_for`) whose JSON goes to the worker
  with the device and dtype as plain names; the worker runs
  :func:`repro_torch.core.spec.build_surfaces_from_spec` — the SAME
  planner-tier call every in-process build makes — and ships the
  surface family back. CUDA cannot start again in a forked child, so a
  build on the card needs a pool made with
  ``mp_context=multiprocessing.get_context("spawn")``; on a fork pool
  the child's build fails and ``poll()`` re-raises that failure like
  any failed build. Generation/swap adoption semantics are
  identical to the thread path (the done-callback publishes under the
  same lock), so process-built surfaces are node-identical to their
  in-process twins.

The executor contract (:class:`RebuildExecutor`): ``submit()`` is
REQUIRED, ``shutdown()`` is OPTIONAL — :class:`ManualExecutor` has
none, and :meth:`SurfaceRebuilder.shutdown` must not assume one.
A dead executor (e.g. an already-terminated process pool) makes
``submit`` raise; the rebuilder stashes that error and re-raises it
from the next ``poll()`` like any failed build — the serving loop
keeps answering from the stale surface either way.

Thread model: ``request()``/``poll()`` are called from the serving
thread and take a small lock only on state transitions (a fast
lock-free precheck keeps the steady-state poll at one attribute read);
the build job runs on the executor and publishes results under the
same lock. The lock is REENTRANT because a process-pool done-callback
can fire inline on the submitting thread (future already finished)
while ``_launch_locked`` still holds it. Build errors are stashed and
re-raised from the next ``poll()`` so a failing rebuild surfaces in
the serving loop instead of dying silently on a worker.
"""

from __future__ import annotations

import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Mapping, Protocol, Sequence

import torch

from repro_torch.core.latency import LinkProfile, SplitCostModel
from repro_torch.core.surface import (
    DEFAULT_LOSS_GRID,
    DEFAULT_PT_SCALES,
    LOSS_CLAMP,
    DegradationSurface,
    _resolve_axes,
)

__all__ = [
    "ManualExecutor",
    "RebuildExecutor",
    "RebuildFanout",
    "RebuildHandle",
    "RebuildRequest",
    "SurfaceRebuilder",
    "recentered_axes",
]

_StateMap = Mapping[str, tuple[float, float]]


class RebuildExecutor(Protocol):
    """What :class:`SurfaceRebuilder` requires of an ``executor``.

    ``submit(fn, *args)`` is the WHOLE required surface — thread pools,
    process pools, and :class:`ManualExecutor` all provide it. Anything
    else is optional: ``shutdown()`` in particular is NOT part of the
    contract (:class:`ManualExecutor` has none), so the rebuilder's own
    :meth:`~SurfaceRebuilder.shutdown` probes for it and tolerates
    executors that are already terminated. ``submit`` may raise (dead
    pool); the rebuilder treats that as a failed build."""

    def submit(self, fn: Callable, /, *args):  # pragma: no cover - protocol
        ...


class ManualExecutor:
    """Deterministic executor: jobs queue until explicitly run.

    ``submit(fn)`` appends; nothing executes until the *caller* invokes
    :meth:`run_next` / :meth:`run_all` (on the calling thread). This
    makes "a rebuild is in flight" an exact, inspectable program state
    — the async tests and the benchmark's in-flight window use it so
    no test ever sleeps or races."""

    def __init__(self):
        self.jobs: list[Callable[[], None]] = []
        self.submitted = 0
        self.executed = 0

    def submit(self, fn: Callable[[], None]) -> None:
        self.jobs.append(fn)
        self.submitted += 1

    def pending(self) -> int:
        """Jobs submitted but not yet run (the in-flight count)."""
        return len(self.jobs)

    def run_next(self) -> bool:
        """Run the oldest pending job; False if none were pending."""
        if not self.jobs:
            return False
        fn = self.jobs.pop(0)
        fn()
        self.executed += 1
        return True

    def run_all(self) -> int:
        """Drain the queue (including jobs enqueued by running jobs)."""
        n = 0
        while self.run_next():
            n += 1
        return n


def recentered_axes(
    protocols: Mapping[str, LinkProfile],
    states: _StateMap | Sequence[_StateMap],
    pt_scale: Sequence[float] = DEFAULT_PT_SCALES,
    loss_p: Sequence[float | None] | None = DEFAULT_LOSS_GRID,
    pt_pad: Sequence[float] = (0.25, 0.5, 1.0, 2.0, 4.0),
    loss_pad: float = 2.0,
) -> tuple[tuple[float, ...], tuple[float | None, ...]]:
    """Surface axes re-centered on drifted estimator states.

    The base grid (``pt_scale`` × ``loss_p``, the manager's configured
    envelope) is EXTENDED — never replaced — with nodes around each
    drifted state: per drifted protocol the packet-time ratio
    ``estimate / nominal`` times each ``pt_pad`` factor joins the scale
    axis, and the drifted loss (plus a ``loss_pad`` headroom multiple,
    capped at the 0.9 link clamp) joins the loss axis. Because
    ``max(pt_pad) >= 1`` and the exact drifted loss is included, every
    requested state is inside the rebuilt surface's envelope, so the
    first post-swap lookup is a surface hit.

    ``states`` is one ``{protocol: (packet_time_s, loss)}`` mapping or a
    sequence of them (a shared rebuilder merges every requester's
    states into one axis set). ``None`` entries in ``loss_p`` keep the
    per-protocol base-loss convention of
    :func:`~repro_torch.core.surface.build_surfaces`."""
    if max(pt_pad) < 1.0:
        raise ValueError(f"max(pt_pad) must be >= 1 so the drifted state "
                         f"lands inside the rebuilt envelope (got {pt_pad})")
    state_maps: Sequence[_StateMap]
    if isinstance(states, Mapping):
        state_maps = (states,)
    else:
        state_maps = tuple(states)
    scales = {float(s) for s in pt_scale}
    has_none = False
    losses: set[float] = set()
    for lp in (loss_p if loss_p is not None else (None,)):
        if lp is None:
            has_none = True
        else:
            losses.add(float(lp))
    for st in state_maps:
        for name, (pt, lp) in st.items():
            base = protocols[name]
            ratio = pt / base.packet_time_s()
            scales.update(ratio * f for f in pt_pad)
            losses.add(min(float(lp), LOSS_CLAMP))
            if loss_pad and lp > 0:
                losses.add(min(float(lp) * loss_pad, LOSS_CLAMP))
    pts = tuple(sorted(s for s in scales if s > 0))
    loss_axis = (None,) * has_none + tuple(sorted(losses))
    return pts, loss_axis


@dataclass(frozen=True)
class RebuildRequest:
    """One versioned rebuild: WHAT the background build will compute.

    ``generation`` orders adoptions (a completed build is only adopted
    while it is still the newest for its fleet size); ``sizes`` are
    every fleet size batched into this build's single
    ``build_surfaces`` call; ``pt_scale``/``loss_p`` are the re-centered
    axes. ``envelopes`` caches each protocol's resolved
    (packet-time max, loss min, loss max) so in-flight coverage checks
    never re-derive axes."""

    generation: int
    sizes: tuple[int, ...]
    pt_scale: tuple[float, ...]
    loss_p: tuple[float | None, ...]
    envelopes: Mapping[str, tuple[float, float, float]] = field(hash=False)

    def covers(self, states: _StateMap) -> bool:
        """Will the surface being built contain ``states``? Below-floor
        packet times and above-``LOSS_CLAMP`` losses clamp inside,
        exactly like :meth:`DegradationSurface.in_envelope
        <repro_torch.core.surface.DegradationSurface.in_envelope>`."""
        for name, (pt, lp) in states.items():
            pt_hi, lo_lo, lo_hi = self.envelopes[name]
            if pt > pt_hi or not lo_lo <= min(lp, LOSS_CLAMP) <= lo_hi:
                return False
        return True


class SurfaceRebuilder:
    """Generation-versioned background surface rebuilds.

    One rebuilder serves one or many
    :class:`~repro_torch.core.adaptive.AdaptiveSplitManager` instances (a
    fleet shares one). The caller contract is two non-blocking calls
    from the serving loop:

    * ``request(n_devices, states)`` — record that ``states`` left the
      envelope. Requests are QUEUED, not built inline; while a build is
      in flight, any number of further requests coalesce into at most
      one queued follow-up (per-protocol targets merge), and requests
      already covered by the in-flight build's axes are dropped.
    * ``poll(n_devices)`` — launch the queued build if nothing is in
      flight AND the caller's own size is queued (a fleet observing
      round-robin therefore queues every drifted size before the first
      requester polls again: one cycle's requests from EVERY manager
      batch into ONE multi-size ``build_surfaces`` call), and return
      the newest completed surface for ``n_devices`` exactly once —
      the atomic swap-on-ready. Returns ``None`` on the (fast,
      lock-free) common path.

    ``executor`` needs only ``submit(fn)`` (see :class:`RebuildExecutor`
    — ``shutdown()`` is optional and probed for, never assumed): the
    default is a single-worker thread pool; pass a
    :class:`ManualExecutor` for deterministic tests, or a
    ``ProcessPoolExecutor`` to move builds out of the serving process —
    the request then travels as the JSON of a
    :class:`~repro_torch.core.spec.PlanSpec` (:meth:`spec_for`) and the
    worker runs :func:`~repro_torch.core.spec.build_surfaces_from_spec`
    on ``device`` / ``dtype`` (a pool for card builds must use the
    ``spawn`` start method: a forked child cannot start CUDA, and its
    failure comes back from ``poll()``). Constructor kwargs mirror
    :func:`~repro_torch.core.surface.build_surfaces` (``pt_scale``/
    ``loss_p`` are the BASE axes every rebuild extends; ``backend``,
    ``device`` and ``dtype`` etc. pass through), so an adopted surface
    is node-identical to the same ``build_surfaces`` call made
    synchronously — :meth:`build_sync` replays exactly that call for
    parity checks."""

    def __init__(
        self,
        cost_model: SplitCostModel,
        protocols: Mapping[str, LinkProfile],
        solver: str = "batched_beam",
        backend: str | None = None,
        beam_width: int = 8,
        chunk_candidates: Sequence[int] | None = None,
        pt_scale: Sequence[float] = DEFAULT_PT_SCALES,
        loss_p: Sequence[float | None] | None = DEFAULT_LOSS_GRID,
        pt_pad: Sequence[float] = (0.25, 0.5, 1.0, 2.0, 4.0),
        loss_pad: float = 2.0,
        executor=None,
        max_queued_states: int = 8,
        energy_budget: float | None = None,
        variants=None,
        accuracy_floor: float | None = None,
        *,
        device=None,
        dtype: torch.dtype = torch.float32,
    ):
        self.cost_model = cost_model
        self.protocols = dict(protocols)
        self.solver = solver
        self.backend = backend
        self.device = device
        self.dtype = dtype
        self.beam_width = beam_width
        self.chunk_candidates = chunk_candidates
        self.energy_budget = energy_budget
        # bottleneck-variant bank + accuracy floor: rebuilt surfaces keep
        # deciding (split, variant) jointly, like the surface they replace
        self.variants = None if variants is None else tuple(variants)
        self.accuracy_floor = accuracy_floor
        self.pt_scale = tuple(pt_scale)
        self.loss_p = None if loss_p is None else tuple(loss_p)
        self.pt_pad = tuple(pt_pad)
        self.loss_pad = loss_pad
        self._executor = executor
        self._own_executor = False
        self._closed = False
        # REENTRANT: a process-pool done-callback runs inline on the
        # submitting thread when the future already finished, i.e.
        # while _launch_locked still holds this lock
        self._lock = threading.RLock()
        self.max_queued_states = max_queued_states
        # per fleet size: a bounded LIST of drifted state maps (one per
        # distinct requester this cycle) — a single merged dict lost all
        # but the last requester's target, so a fleet of sessions drifting
        # to different points rebuilt a surface centered on only one of
        # them. Overflow past max_queued_states merges into the last
        # entry by per-protocol max (the envelope-dominant direction),
        # bounding the rebuilt grid size.
        self._queued: dict[int, list[dict[str, tuple[float, float]]]] = {}
        self._inflight: RebuildRequest | None = None
        self._results: dict[int, tuple[int, DegradationSurface]] = {}
        self._adopted_gen: dict[int, int] = {}
        self._error: BaseException | None = None
        # lock-free precheck for poll(): True only when poll might have
        # work (queued build to launch, result to adopt, error to raise)
        self._maybe_actionable = False
        self.generation = 0
        self.builds_started = 0
        self.builds_completed = 0
        self.requests = 0
        self.requests_coalesced = 0
        self.last_request: RebuildRequest | None = None

    # -- serving-loop API --------------------------------------------------
    def request(self, n_devices: int, states: _StateMap) -> str:
        """Record a drift-triggered rebuild for fleet size ``n_devices``
        re-centered on ``states``. Never builds inline. Returns the
        disposition: ``"queued"`` (new queue entry — the next ``poll``
        launches it), ``"coalesced"`` (merged into an existing queue
        entry), or ``"inflight"`` (already covered by the build in
        flight)."""
        with self._lock:
            self.requests += 1
            if (self._inflight is not None
                    and n_devices in self._inflight.sizes
                    and self._inflight.covers(states)):
                self.requests_coalesced += 1
                return "inflight"
            pending = self._queued.get(n_devices)
            if pending is not None:
                if len(pending) < self.max_queued_states:
                    pending.append(dict(states))
                else:  # bounded: fold into the last entry, per-protocol max
                    last = pending[-1]
                    for name, (pt, lp) in states.items():
                        pt0, lp0 = last.get(name, (pt, lp))
                        last[name] = (max(pt0, pt), max(lp0, lp))
                self.requests_coalesced += 1
                return "coalesced"
            self._queued[n_devices] = [dict(states)]
            self._maybe_actionable = True
            return "queued"

    def poll(self, n_devices: int) -> DegradationSurface | None:
        """Launch any queued build (if idle) and hand over the newest
        completed surface for ``n_devices`` exactly once. The common
        no-op path is a single attribute read — safe on every
        ``observe()``."""
        got = self.poll_versioned(n_devices)
        return None if got is None else got[1]

    def poll_versioned(
        self, n_devices: int,
    ) -> tuple[int, DegradationSurface] | None:
        """:meth:`poll`, but the handover is ``(generation, surface)`` so
        a redistributing consumer (:class:`RebuildFanout`) can order
        adoptions downstream. Same exactly-once / newest-only
        semantics."""
        if not self._maybe_actionable:
            return None
        with self._lock:
            if self._error is not None:
                err, self._error = self._error, None
                self._refresh_actionable_locked()
                raise RuntimeError(
                    "async surface rebuild failed; the serving loop must "
                    "decide whether to keep the stale surface") from err
            # launch only when the CALLER's size is among the queued
            # ones: in a fleet observing round-robin, every drifted
            # manager requests before the first requester polls again,
            # so one cycle's drift coalesces into ONE multi-size build
            if self._inflight is None and n_devices in self._queued:
                self._launch_locked()
            out = None
            got = self._results.get(n_devices)
            if got is not None:
                gen, surf = got
                del self._results[n_devices]
                if gen > self._adopted_gen.get(n_devices, -1):
                    self._adopted_gen[n_devices] = gen
                    out = (gen, surf)
            self._refresh_actionable_locked()
            return out

    def inflight(self) -> RebuildRequest | None:
        """The build currently running (None when idle)."""
        return self._inflight

    def shutdown(self) -> None:
        """Stop rebuilding, TERMINALLY: no further build ever launches
        (queued requests stay queued; completed results remain
        adoptable). Waits for and releases the internally created
        executor; injected executors are left to their owner. The
        executor contract makes ``shutdown`` optional
        (:class:`RebuildExecutor`), so this probes for it and tolerates
        executors that are already terminated — e.g. a process pool
        whose workers died. Idempotent — also the completion barrier
        deterministic thread tests use."""
        with self._lock:
            self._closed = True
            if not self._own_executor:
                return
            ex, self._executor = self._executor, None
            self._own_executor = False
        stop = getattr(ex, "shutdown", None)
        if stop is None:
            return
        try:
            stop(wait=True)
        except Exception:  # already-terminated/broken pool: nothing to stop
            pass

    # -- build machinery ---------------------------------------------------
    def spec_for(self, req: RebuildRequest):
        """The serializable :class:`~repro_torch.core.spec.PlanSpec` a
        request resolves to — the rebuilder config plus the request's
        re-centered axes. This is the value that crosses the process
        boundary in pool mode, and
        :func:`~repro_torch.core.spec.build_surfaces_from_spec` on it is
        the EXACT call every in-process build makes too."""
        from repro_torch.core.spec import surfaces_spec

        return surfaces_spec(
            self.cost_model, self.protocols, req.sizes,
            pt_scale=req.pt_scale, loss_p=req.loss_p,
            solver=self.solver, backend=self.backend,
            beam_width=self.beam_width,
            chunk_candidates=self.chunk_candidates,
            energy_budget=self.energy_budget,
            variants=self.variants,
            accuracy_floor=self.accuracy_floor,
        )

    def build_sync(self, req: RebuildRequest) -> dict[int, DegradationSurface]:
        """The EXACT planner-tier call a request resolves to — shared by
        the background job (thread AND process mode) and by parity
        checks, so an async-adopted surface is node-identical to this
        synchronous value by construction."""
        from repro_torch.core.spec import build_surfaces_from_spec

        return build_surfaces_from_spec(self.spec_for(req), *self._where())

    def _where(self) -> tuple[str | None, str]:
        """``device`` / ``dtype`` as the plain names the spec worker takes
        (picklable for a process pool)."""
        device = None if self.device is None else str(self.device)
        return device, str(self.dtype).removeprefix("torch.")

    def _resolved_envelopes(
        self, pt_scale: tuple[float, ...], loss_p: tuple[float | None, ...],
    ) -> dict[str, tuple[float, float, float]]:
        """Per-protocol (pt max, loss min, loss max) exactly as
        ``build_surfaces`` will resolve the axes — via the SAME
        :func:`repro_torch.core.surface._resolve_axes` helper, so a coverage
        prediction can never drift from what the build produces."""
        env = {}
        for name, base in self.protocols.items():
            pts, losses = _resolve_axes(base, pt_scale, loss_p)
            env[name] = (pts[-1], losses[0], losses[-1])
        return env

    def _launch_locked(self) -> None:
        if self._closed:  # terminal: never resurrect an executor
            return
        sizes = tuple(sorted(self._queued))
        pts, losses = recentered_axes(
            self.protocols,
            tuple(st for lst in self._queued.values() for st in lst),
            pt_scale=self.pt_scale, loss_p=self.loss_p,
            pt_pad=self.pt_pad, loss_pad=self.loss_pad)
        self._queued.clear()
        self.generation += 1
        req = RebuildRequest(
            generation=self.generation, sizes=sizes,
            pt_scale=pts, loss_p=losses,
            envelopes=self._resolved_envelopes(pts, losses))
        self._inflight = req
        self.last_request = req
        self.builds_started += 1
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="surface-rebuild")
            self._own_executor = True
        try:
            if isinstance(self._executor, ProcessPoolExecutor):
                # lambdas (and bound methods over a live rebuilder)
                # don't pickle: ship the spec JSON (and the device and
                # dtype names) to the module-level worker and publish
                # from the done-callback in THIS process. The callback
                # may run inline (RLock). A fork pool cannot start CUDA
                # in the child: that build fails and poll() re-raises it.
                from repro_torch.core.spec import build_surfaces_from_spec

                fut = self._executor.submit(
                    build_surfaces_from_spec, self.spec_for(req).to_json(),
                    *self._where())
                fut.add_done_callback(
                    lambda f, req=req: self._finish_future(req, f))
            else:
                self._executor.submit(lambda: self._run_build(req))
        except BaseException as e:  # noqa: BLE001 - dead/broken pool
            # submit on a terminated pool raises in the SERVING thread;
            # surface it like any failed build instead of crashing the
            # poll that launched us (the serving loop keeps the stale
            # surface)
            self._fail_locked(e)

    def _run_build(self, req: RebuildRequest) -> None:
        try:
            surfaces = self.build_sync(req)
        except BaseException as e:  # noqa: BLE001 - surfaced via poll()
            with self._lock:
                self._fail_locked(e)
            return
        with self._lock:
            self._publish_locked(req, surfaces)

    def _finish_future(self, req: RebuildRequest, fut) -> None:
        """Done-callback for process-pool builds: publish the shipped
        surfaces (or the worker's exception) with the same
        generation/swap semantics as :meth:`_run_build`."""
        try:
            surfaces = fut.result()
        except BaseException as e:  # noqa: BLE001 - surfaced via poll()
            with self._lock:
                self._fail_locked(e)
            return
        with self._lock:
            self._publish_locked(req, surfaces)

    def _fail_locked(self, err: BaseException) -> None:
        self._error = err
        self._inflight = None
        self._maybe_actionable = True

    def _publish_locked(
        self, req: RebuildRequest,
        surfaces: Mapping[int, DegradationSurface],
    ) -> None:
        for n, surf in surfaces.items():
            self._results[n] = (req.generation, surf)
        self._inflight = None
        self.builds_completed += 1
        self._maybe_actionable = True

    def _refresh_actionable_locked(self) -> None:
        self._maybe_actionable = (
            bool(self._results)
            or self._error is not None
            or (not self._closed and self._inflight is None
                and bool(self._queued))
        )


class RebuildFanout:
    """Multiplexes ONE :class:`SurfaceRebuilder` across MANY consumers.

    ``SurfaceRebuilder.poll`` hands each completed surface out exactly
    once per fleet size — correct for one manager per size, but a
    serving gateway runs THOUSANDS of sessions sharing one rebuilder,
    and every session must see every adopted surface. The fanout is the
    rebuilder's sole consumer (via :meth:`SurfaceRebuilder.poll_versioned`)
    and redistributes: completed builds land in a shared
    ``{n_devices: (generation, surface)}`` map, and each
    :meth:`view` hands out a :class:`RebuildHandle` that adopts from
    that map independently — newest-generation-only per consumer, so a
    stale build can never replace a newer one for ANY session (the
    rebuilder's generation/swap semantics, per handle).

    ``seq`` bumps whenever the shared map changes; handles use it for a
    lock-free "anything new since I looked?" precheck, keeping the
    per-session steady-state poll at two attribute reads."""

    def __init__(self, rebuilder: SurfaceRebuilder):
        self.rebuilder = rebuilder
        self._lock = threading.Lock()
        self._latest: dict[int, tuple[int, DegradationSurface]] = {}
        self.seq = 0

    def refresh(self, n_devices: int) -> bool:
        """Drain the rebuilder's exactly-once handover for ``n_devices``
        into the shared map (launching any queued build, per the
        ``poll`` contract). True if the map changed."""
        got = self.rebuilder.poll_versioned(n_devices)
        if got is None:
            return False
        gen, surf = got
        with self._lock:
            cur = self._latest.get(n_devices)
            if cur is not None and cur[0] >= gen:
                return False
            self._latest[n_devices] = (gen, surf)
            self.seq += 1
        return True

    def latest(self, n_devices: int) -> tuple[int, DegradationSurface] | None:
        """Newest completed (generation, surface) for ``n_devices``."""
        return self._latest.get(n_devices)

    def view(self) -> "RebuildHandle":
        """A new per-consumer adoption view (one per session)."""
        return RebuildHandle(self)

    def shutdown(self) -> None:
        """Shut the underlying rebuilder down (terminal)."""
        self.rebuilder.shutdown()


class RebuildHandle:
    """One consumer's view of a shared :class:`RebuildFanout`.

    Implements the same duck-typed contract
    :class:`~repro_torch.core.adaptive.AdaptiveSplitManager` drives its
    rebuilder with — ``request(n, states)`` / ``poll(n)`` /
    ``shutdown()`` — so a session manager wires to a handle exactly as
    it would to a private :class:`SurfaceRebuilder`:

    * ``request`` forwards to the shared rebuilder (where the whole
      fleet's drift coalesces into one multi-size build per cycle);
    * ``poll`` adopts from the fanout's shared map at most once per
      generation per fleet size (``adoptions`` records every
      ``(n_devices, generation)`` handover, strictly increasing in
      generation per size — the zero-stale-adoption audit trail);
    * ``shutdown`` is a no-op: the fanout's owner closes the shared
      rebuilder once, not once per session."""

    def __init__(self, fanout: RebuildFanout):
        self._fanout = fanout
        self._seen_seq = -1
        self._adopted_gen: dict[int, int] = {}
        self.adoptions: list[tuple[int, int]] = []

    def request(self, n_devices: int, states: _StateMap) -> str:
        return self._fanout.rebuilder.request(n_devices, states)

    def poll(self, n_devices: int) -> DegradationSurface | None:
        fo = self._fanout
        # lock-free steady state: nothing actionable on the rebuilder
        # AND nothing new in the shared map since this handle looked
        if not fo.rebuilder._maybe_actionable and fo.seq == self._seen_seq:
            return None
        fo.refresh(n_devices)
        self._seen_seq = fo.seq
        got = fo.latest(n_devices)
        if got is None:
            return None
        gen, surf = got
        if gen <= self._adopted_gen.get(n_devices, -1):
            return None
        self._adopted_gen[n_devices] = gen
        self.adoptions.append((n_devices, gen))
        return surf

    def shutdown(self) -> None:
        """No-op — see the class docstring."""
