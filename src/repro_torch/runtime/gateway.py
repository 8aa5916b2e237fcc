"""Fleet serving gateway — thousands of device sessions, one planner.

The port's counterpart of ``repro.runtime.gateway``, line for line but
for the dispatch: the gateway takes ``backend=None, device=None,
dtype=torch.float32`` as keywords and hands that triple to its family
build, its shared rebuilder and every session's manager (``None``
resolves per solver: the card for ``solver="optimal_dp"``).

The paper's runtime story is ONE sensor metering hops against one plan;
the production shape is a gateway multiplexing thousands of concurrent
device sessions onto the planning stack:

* **Sessions** register/drop dynamically. Each
  :class:`GatewaySession` owns a
  :class:`~repro_torch.runtime.server.SplitLatencyMeter` plus the per-protocol
  :class:`~repro_torch.core.adaptive.LinkEstimator` state inside its
  :class:`~repro_torch.core.adaptive.AdaptiveSplitManager` — per-session link
  drift, per-session decisions.
* **One shared rebuilder.** Every session's manager wires to a
  :class:`~repro_torch.core.async_replan.RebuildHandle` view of ONE shared
  :class:`~repro_torch.core.async_replan.SurfaceRebuilder` (via
  :class:`~repro_torch.core.async_replan.RebuildFanout`), so fleet-wide drift
  coalesces into single batched ``build_surfaces`` calls — N drifting
  sessions cost one solve per cycle, and the rebuilder's
  generation/swap semantics hold per session (a stale build is never
  adopted).
  Sessions bring up cheaply: the per-size surface family is prebuilt in
  ONE multi-size solve at gateway construction, managers start with
  ``initial="surface"`` (an O(1) lookup, no per-registration solve) and
  run ``offsurface_fallback="stale"`` (drift requests a rebuild and
  keeps serving the stale decision — no inline re-solves on the event
  path).
* **Bounded ingress + QoS.** Events (measured hops, token ticks) enter
  a bounded queue; past ``max_pending`` they are SHED and counted —
  admission control, not unbounded growth. Every processed observe is
  timed into per-session and fleet-global rolling windows
  (:class:`~repro_torch.runtime.stats.QosMonitor`), and :meth:`snapshot`
  emits a :class:`~repro_torch.runtime.stats.FleetSnapshot`: p50/p99 observe
  latency, summed adaptive counters (``surface_hits`` /
  ``exact_fallbacks`` / ``rebuild_requests`` / ``surface_swaps`` /
  ``stale_serves``), shed/build counters, and a stale-adoption audit.

``pump()`` drains the queue synchronously (deterministic tests drive
it directly); :meth:`serve` is the asyncio wrapper that pumps forever
until :meth:`stop`.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import replace
from typing import Mapping, Sequence

import torch

from repro_torch.core.adaptive import AdaptiveSplitManager, _batched_twin, _one_backend
from repro_torch.core.async_replan import RebuildFanout, SurfaceRebuilder
from repro_torch.core.latency import LinkProfile, SplitCostModel
from repro_torch.core.spec import PlannerService, surfaces_spec
from repro_torch.core.surface import DEFAULT_LOSS_GRID, DEFAULT_PT_SCALES
from repro_torch.runtime.server import SplitLatencyMeter
from repro_torch.runtime.stats import (
    FleetSnapshot,
    QosMonitor,
    RollingWindow,
    SessionSnapshot,
)

__all__ = ["FleetGateway", "GatewaySession"]


class GatewaySession:
    """One registered device session: a latency meter wired to its own
    adaptive manager, which shares the gateway's rebuilder through a
    per-session :class:`~repro_torch.core.async_replan.RebuildHandle`."""

    __slots__ = ("session_id", "n_devices", "manager", "meter", "handle",
                 "observes", "tokens")

    def __init__(self, session_id: str, n_devices: int,
                 manager: AdaptiveSplitManager, meter: SplitLatencyMeter,
                 handle) -> None:
        self.session_id = session_id
        self.n_devices = n_devices
        self.manager = manager
        self.meter = meter
        self.handle = handle
        self.observes = 0
        self.tokens = 0

    @property
    def protocol(self) -> str | None:
        """The protocol the session is currently priced/observed on
        (follows cross-protocol replans via the meter)."""
        return self.meter.protocol

    def observe(self, nbytes: int, latency_s: float, retries: int = 0) -> bool:
        """One device-reported hop measurement; True if it triggered a
        replan adoption."""
        self.observes += 1
        return self.meter.observe_hop(nbytes, latency_s, retries)

    def on_token(self) -> None:
        """One generated token: price every inter-segment hop on the
        session's current plan/link (feeding the estimators)."""
        self.tokens += 1
        self.meter.on_token()

    def counters(self) -> dict[str, int]:
        return self.manager.counters()

    def adoption_violations(self) -> int:
        """Stale-adoption audit: adopted generations must be strictly
        increasing per fleet size (0 = the swap contract held)."""
        last: dict[int, int] = {}
        bad = 0
        for n, gen in self.handle.adoptions:
            if gen <= last.get(n, -1):
                bad += 1
            last[n] = gen
        return bad


class FleetGateway:
    """Asyncio serving gateway multiplexing device sessions onto one
    shared planning stack. See the module docstring for the layer map.

    ``fleet_sizes`` fixes the device-count vocabulary up front so the
    whole surface family is built in ONE multi-size ``build_surfaces``
    call; ``executor`` (anything with ``submit``, e.g.
    :class:`~repro_torch.core.async_replan.ManualExecutor`) makes rebuild
    timing deterministic in tests. ``manager_kwargs`` pass through to
    every session's :class:`~repro_torch.core.adaptive.AdaptiveSplitManager`
    (e.g. ``replan_threshold``, ``stale_rtol``). ``backend`` / ``device``
    / ``dtype`` say where the family build, the rebuilds and every
    session's exact re-solves run (a ``"backend"`` entry of
    ``surface_grid`` stands for ``backend``)."""

    def __init__(
        self,
        cost_model: SplitCostModel,
        protocols: Mapping[str, LinkProfile],
        fleet_sizes: Sequence[int],
        *,
        solver: str = "beam",
        surface_grid: dict | None = None,
        executor=None,
        max_pending: int = 4096,
        session_window: int = 256,
        fleet_window: int = 8192,
        clock=time.perf_counter,
        backend: str | None = None,
        device=None,
        dtype: torch.dtype = torch.float32,
        **manager_kwargs,
    ):
        self.cost_model = cost_model
        self.protocols = dict(protocols)
        self.fleet_sizes = tuple(dict.fromkeys(int(n) for n in fleet_sizes))
        self.solver = solver
        self.surface_grid = dict(surface_grid or {})
        self.backend = _one_backend(backend, self.surface_grid)
        self.device = device
        self.dtype = dtype
        self.max_pending = max_pending
        self.manager_kwargs = manager_kwargs
        self._clock = clock
        batched = _batched_twin(solver)
        # the WHOLE per-size surface family in one batched solve; the
        # request is kept as a serializable PlanSpec (``plan_spec``) —
        # the same object a process-pool rebuild would ship — and the
        # family is resolved from it
        grid = dict(self.surface_grid)
        grid["backend"] = self.backend
        grid.setdefault("pt_scale", DEFAULT_PT_SCALES)
        grid.setdefault("loss_p", DEFAULT_LOSS_GRID)
        if "mesh_spec" in grid:  # build_surfaces spells the knob mesh_spec
            grid["mesh"] = grid.pop("mesh_spec")
        self.plan_spec = surfaces_spec(
            cost_model, self.protocols, self.fleet_sizes,
            solver=batched, **grid)
        self.surfaces = PlannerService(device, dtype).build_surfaces(
            self.plan_spec)
        rebuild = dict(self.surface_grid)
        rebuild["backend"] = self.backend
        self.rebuilder = SurfaceRebuilder(
            cost_model, self.protocols, solver=batched,
            executor=executor, device=device, dtype=dtype, **rebuild)
        self.fanout = RebuildFanout(self.rebuilder)
        # link-independent local cost tensors, one per fleet size,
        # shared by every session of that size
        self._local_tensors = {
            n: cost_model.local_cost_tensor(n) for n in self.fleet_sizes}
        self.sessions: dict[str, GatewaySession] = {}
        self.qos = QosMonitor(key_window=session_window,
                              global_window=fleet_window)
        # token-loop wall times get their own window (the fleet p50/p99
        # in snapshots cover OBSERVE handling only)
        self.token_window = RollingWindow(fleet_window)
        self._queue: deque[tuple] = deque()
        self._running = False
        self._snapshots = 0
        self.registered_total = 0
        self.dropped_total = 0
        self.rebuild_errors = 0

    # -- session lifecycle -------------------------------------------------
    def register(self, session_id: str, n_devices: int,
                 bytes_per_token: int = 0) -> GatewaySession:
        """Bring up a session: O(1) surface-lookup initial decision (no
        per-registration solve), a fresh manager sharing the prebuilt
        surface + local tensor for its fleet size, and a meter following
        the initial decision's protocol/link."""
        if session_id in self.sessions:
            raise ValueError(f"session {session_id!r} already registered")
        if n_devices not in self.surfaces:
            raise KeyError(
                f"n_devices={n_devices} not in the gateway's prebuilt "
                f"family {self.fleet_sizes}")
        handle = self.fanout.view()
        manager = AdaptiveSplitManager(
            cost_model=self.cost_model, protocols=dict(self.protocols),
            n_devices=n_devices, solver=self.solver,
            surface=self.surfaces[n_devices],
            surface_grid=self.surface_grid or None,
            async_rebuild=handle,
            initial="surface", offsurface_fallback="stale",
            local_tensor=self._local_tensors[n_devices],
            backend=self.backend, device=self.device, dtype=self.dtype,
            **self.manager_kwargs)
        cur = manager.current
        if cur is None:
            raise RuntimeError(
                f"no feasible initial plan for n_devices={n_devices}")
        meter = SplitLatencyMeter(
            plan=manager.current_plan(),
            link=replace(self.protocols[cur.protocol],
                         mtu_bytes=cur.chunk_bytes),
            bytes_per_token=bytes_per_token,
            manager=manager, protocol=cur.protocol)
        sess = GatewaySession(session_id, n_devices, manager, meter, handle)
        self.sessions[session_id] = sess
        self.registered_total += 1
        self.qos.bump("registrations")
        return sess

    def drop(self, session_id: str) -> bool:
        """Remove a session (its queued events are discarded when
        pumped; its QoS window is released). False if unknown."""
        sess = self.sessions.pop(session_id, None)
        if sess is None:
            return False
        sess.manager.close()  # no-op for the shared handle, by contract
        self.qos.drop(session_id)
        self.dropped_total += 1
        self.qos.bump("drops")
        return True

    # -- event ingress (bounded, shedding) ---------------------------------
    def submit_observe(self, session_id: str, nbytes: int,
                       latency_s: float, retries: int = 0) -> bool:
        """Enqueue a device-reported hop measurement. False = SHED (queue
        at ``max_pending``) — counted, never silently dropped."""
        return self._submit(("observe", session_id, nbytes,
                             latency_s, retries))

    def submit_token(self, session_id: str) -> bool:
        """Enqueue a token-loop tick for the session."""
        return self._submit(("token", session_id))

    def _submit(self, event: tuple) -> bool:
        if len(self._queue) >= self.max_pending:
            self.qos.bump("events_shed")
            return False
        self._queue.append(event)
        self.qos.bump("events_submitted")
        return True

    @property
    def pending(self) -> int:
        return len(self._queue)

    # -- event processing --------------------------------------------------
    def pump(self, max_events: int | None = None) -> int:
        """Drain up to ``max_events`` queued events synchronously (all of
        them when None). Observe/token handling is timed into the QoS
        windows; a failed background rebuild surfacing through
        ``observe`` is counted (``rebuild_errors``) and serving
        continues on the stale surface."""
        done = 0
        while self._queue and (max_events is None or done < max_events):
            event = self._queue.popleft()
            done += 1
            sess = self.sessions.get(event[1])
            if sess is None:  # dropped while queued
                self.qos.bump("events_orphaned")
                continue
            t0 = self._clock()
            try:
                if event[0] == "observe":
                    _, sid, nbytes, latency_s, retries = event
                    sess.observe(nbytes, latency_s, retries)
                    self.qos.record(sid, self._clock() - t0)
                else:
                    sess.on_token()
                    self.qos.bump("tokens_processed")
                    self.token_window.add(self._clock() - t0)
            except RuntimeError:
                # a background rebuild failed; the session keeps serving
                # from its stale surface and the next material drift
                # re-requests (the manager reset its staleness window)
                self.rebuild_errors += 1
                self.qos.bump("rebuild_errors")
            self.qos.bump("events_processed")
        return done

    # -- asyncio surface ---------------------------------------------------
    async def serve(self, *, batch: int = 256,
                    idle_sleep_s: float = 0.001) -> None:
        """Pump the event queue forever (until :meth:`stop`): drain up
        to ``batch`` events per scheduling slice, yield to the loop
        between slices, sleep briefly when idle. Register/drop/submit
        freely from other coroutines while this runs."""
        self._running = True
        try:
            while self._running:
                n = self.pump(batch)
                if n == 0:
                    await asyncio.sleep(idle_sleep_s)
                else:
                    await asyncio.sleep(0)  # cooperative yield
        finally:
            self._running = False

    def stop(self) -> None:
        self._running = False

    # -- QoS ---------------------------------------------------------------
    def snapshot(self, include_sessions: bool = False) -> FleetSnapshot:
        """Periodic fleet snapshot. Also sweeps the fanout across every
        fleet size so completed rebuilds are published even for sizes
        whose sessions all dropped mid-build (otherwise an unclaimed
        result would keep the rebuilder's fast-path flag hot forever)."""
        for n in self.fleet_sizes:
            try:
                self.fanout.refresh(n)
            except RuntimeError:
                self.rebuild_errors += 1
                self.qos.bump("rebuild_errors")
        counters: dict[str, int] = dict(self.qos.counters)
        agg: dict[str, int] = {}
        violations = 0
        per_session: list[SessionSnapshot] = []
        for sid, sess in self.sessions.items():
            for k, v in sess.counters().items():
                agg[k] = agg.get(k, 0) + v
            violations += sess.adoption_violations()
            if include_sessions:
                p50, p99 = self.qos.key_percentiles(sid)
                per_session.append(SessionSnapshot(
                    session_id=sid, n_devices=sess.n_devices,
                    observes=sess.observes, p50_s=p50, p99_s=p99,
                    counters=sess.counters()))
        counters.update(agg)
        counters["stale_adoption_violations"] = violations
        counters["builds_started"] = self.rebuilder.builds_started
        counters["builds_completed"] = self.rebuilder.builds_completed
        counters["rebuilder_requests"] = self.rebuilder.requests
        counters["rebuilder_requests_coalesced"] = \
            self.rebuilder.requests_coalesced
        counters["queue_depth"] = len(self._queue)
        p50, p99 = self.qos.fleet_percentiles()
        self._snapshots += 1
        return FleetSnapshot(
            seq=self._snapshots, n_sessions=len(self.sessions),
            observes=self.qos.global_window.count, p50_s=p50, p99_s=p99,
            counters=counters, sessions=tuple(per_session))

    def close(self) -> None:
        """Shut the shared rebuilder down (terminal; sessions keep
        serving from their current surfaces)."""
        self.stop()
        self.fanout.shutdown()
