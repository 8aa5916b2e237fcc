"""Stale-while-revalidate rebuilds (``repro_torch.core.async_replan``)
against the reference's, step by step.

Every rebuild here runs on a :class:`ManualExecutor` unless a test says
otherwise, so "a build is in flight" is an exact program state. The port
and the reference take the same calls (``backend="numpy"``) and must
answer alike at every step: each request's disposition (queued,
coalesced, covered by the build in flight), each poll's handover (one
per generation, node for node the reference's family), the counters, the
re-centered axes and envelopes of each request, and a failed launch
re-raised from ``poll``. One rebuild goes through a ``spawn`` process
pool on ``device="cpu"`` and must equal the thread-built family."""

import multiprocessing as mp
import time
from concurrent.futures import ProcessPoolExecutor

import pytest

from repro.core import async_replan as RAR
from repro.core import profiles as RP
from repro_torch import convert
from repro_torch.core import async_replan as PAR
from repro_torch.core import cuda_dp as CD
from torch_parity import protocols, surface_fields

GRID = {"pt_scale": (1.0, 4.0, 16.0), "loss_p": (0.0, 0.1)}
NOMINAL = {name: (lk.packet_time_s(), lk.loss_p) for name, lk in RP.PROTOCOLS.items()}


def drifted(factor, loss, names=("esp_now",)):
    """Estimator states with ``names`` at ``factor`` x their nominal
    packet time and loss ``loss``."""
    return {n: (NOMINAL[n][0] * factor, loss) for n in names}


def model(port):
    ref = RP.paper_cost_model("mobilenet_v2", "esp_now")
    return convert.cost_model_from_reference(ref) if port else ref


def rebuilder(port, executor, **kw):
    mod = PAR if port else RAR
    kw.setdefault("solver", "batched_dp")
    kw.setdefault("backend", "numpy")
    return mod.SurfaceRebuilder(model(port), protocols(RP.PROTOCOLS, port),
                                executor=executor, **GRID, **kw)


def request_fields(req):
    if req is None:
        return None
    return (req.generation, req.sizes, req.pt_scale, req.loss_p, dict(req.envelopes))


def state(rb):
    return (rb.generation, rb.builds_started, rb.builds_completed, rb.requests,
            rb.requests_coalesced, request_fields(rb.inflight()),
            request_fields(rb.last_request), sorted(rb._queued), rb._maybe_actionable)


def handed(surface):
    return None if surface is None else surface_fields(surface)


def script(rb, ex):
    """One scripted run of a rebuilder: requests, polls and builds in a
    fixed order. Returns what every step answered, and the state after."""
    log = []

    def step(label, value):
        log.append((label, value, state(rb)))

    step("request 2", rb.request(2, drifted(30.0, 0.05)))
    step("request 3", rb.request(3, drifted(50.0, 0.2, ("esp_now", "ble"))))
    step("request 2 again", rb.request(2, drifted(300.0, 0.0)))
    step("poll 3 (launches 2 and 3)", handed(rb.poll(3)))
    step("covered request", rb.request(3, drifted(40.0, 0.2)))
    step("request beyond the build", rb.request(2, drifted(5000.0, 0.3)))
    step("poll 2 while in flight", handed(rb.poll(2)))
    step("build", ex.run_all())
    step("poll 3 adopts", handed(rb.poll(3)))
    step("poll 3 once only", handed(rb.poll(3)))
    step("poll 2 adopts and launches", handed(rb.poll(2)))
    step("build", ex.run_all())
    step("poll 2 adopts generation 2", handed(rb.poll(2)))
    step("poll 2 once only", handed(rb.poll(2)))
    step("poll 3 has nothing newer", handed(rb.poll(3)))
    return log


def test_recentered_axes_equal_the_references():
    for states, kw in (
            (drifted(300.0, 0.25), dict(pt_scale=(1.0, 4.0), loss_p=(0.0, 0.1))),
            ([drifted(50.0, 0.0), drifted(900.0, 0.0, ("ble", "udp"))],
             dict(pt_scale=(1.0,), loss_p=(0.0,))),
            (drifted(7.0, 0.6, ("tcp", "esp_now")), dict(loss_p=(None, 0.05))),
            (drifted(2.0, 0.1), dict(loss_p=None, loss_pad=0.0)),
            (drifted(0.5, 0.95), {})):
        want = RAR.recentered_axes(dict(RP.PROTOCOLS), states, **kw)
        got = PAR.recentered_axes(protocols(RP.PROTOCOLS, True), states, **kw)
        assert got == want
    with pytest.raises(ValueError, match="pt_pad"):
        PAR.recentered_axes(protocols(RP.PROTOCOLS, True), drifted(2.0, 0.0),
                            pt_pad=(0.25, 0.5))


def test_manual_executor_runs_in_order():
    ex = PAR.ManualExecutor()
    order = []
    ex.submit(lambda: order.append("a"))
    ex.submit(lambda: (order.append("b"), ex.submit(lambda: order.append("c"))))
    assert ex.pending() == 2 and ex.submitted == 2 and ex.executed == 0
    assert ex.run_next() and order == ["a"]
    assert ex.run_all() == 2 and order == ["a", "b", "c"]
    assert not ex.run_next() and ex.executed == 3


@pytest.mark.parametrize("solver", ["batched_dp", "batched_greedy"])
def test_rebuilder_sequence_equals_the_references(solver):
    logs = []
    for port in (False, True):
        ex = (PAR if port else RAR).ManualExecutor()
        rb = rebuilder(port, ex, solver=solver)
        logs.append(script(rb, ex))
        rb.shutdown()
    want, got = logs
    assert [x[0] for x in got] == [x[0] for x in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    dispositions = [x[1] for x in got if x[0].startswith(("request", "covered"))]
    assert dispositions == ["queued", "queued", "coalesced", "inflight", "queued"]
    assert sum(x[1] is not None for x in got if x[0].startswith("poll")) == 3


def test_rebuilder_builds_are_build_sync():
    ex = PAR.ManualExecutor()
    rb = rebuilder(True, ex)
    rb.request(2, drifted(30.0, 0.05))
    rb.poll(2)
    req = rb.inflight()
    ex.run_all()
    assert surface_fields(rb.poll(2)) == surface_fields(rb.build_sync(req)[2])
    assert rb.spec_for(req).backend == "numpy"


class DeadExecutor:
    def submit(self, fn, *args):
        raise RuntimeError("executor is gone")


def test_failed_launch_is_reraised_from_poll():
    """A submit that raises (a dead pool) is stashed and re-raised from the
    next poll, as in the reference; the rebuilder then launches again."""
    seen = []
    for port in (False, True):
        rb = rebuilder(port, DeadExecutor())
        assert rb.request(2, drifted(30.0, 0.05)) == "queued"
        assert rb.poll(2) is None
        with pytest.raises(RuntimeError, match="async surface rebuild failed") as ei:
            rb.poll(2)
        assert str(ei.value.__cause__) == "executor is gone"
        assert rb.poll(2) is None  # the error is handed over once
        seen.append(state(rb))
    assert seen[0] == seen[1]


def test_a_card_build_without_a_card_fails_through_poll(monkeypatch):
    """The port's own failure: a rebuild on the card (``backend=None``:
    the fused kernel) where there is none raises in the job, and ``poll``
    re-raises it; nothing falls back to the host."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex = PAR.ManualExecutor()
    rb = rebuilder(True, ex, backend=None)
    rb.request(2, drifted(30.0, 0.05))
    rb.poll(2)
    ex.run_all()
    with pytest.raises(RuntimeError, match="async surface rebuild failed") as ei:
        rb.poll(2)
    assert "no CUDA card" in str(ei.value.__cause__)


def test_fanout_hands_every_view_each_generation_once():
    runs = []
    for port in (False, True):
        mod = PAR if port else RAR
        ex = mod.ManualExecutor()
        fan = mod.RebuildFanout(rebuilder(port, ex))
        a, b = fan.view(), fan.view()
        out = [a.request(2, drifted(30.0, 0.05)), a.poll(2), b.poll(2)]
        ex.run_all()
        out += [handed(a.poll(2)), handed(b.poll(2)), a.poll(2), b.poll(2)]
        out.append(b.request(2, drifted(3000.0, 0.2)))
        out.append(handed(a.poll(2)))  # launches generation 2
        ex.run_all()
        late = fan.view()
        out += [handed(late.poll(2)), handed(b.poll(2)), handed(a.poll(2)), a.poll(2)]
        out += [a.adoptions, b.adoptions, late.adoptions, fan.seq,
                fan.refresh(2), fan.latest(3)]
        a.shutdown()  # a no-op: the fanout's owner closes the rebuilder
        assert not fan.rebuilder._closed
        fan.shutdown()
        assert fan.rebuilder._closed
        runs.append(out)
    assert runs[1] == runs[0]
    assert runs[1][-6:-3] == [[(2, 1), (2, 2)], [(2, 1), (2, 2)], [(2, 2)]]


def test_spawn_pool_rebuild_equals_the_thread_build():
    """One rebuild on a ``spawn`` process pool (the spec's JSON and the
    device name cross the boundary) on ``device="cpu"`` with the fused
    kernel's plain version: node for node the family a thread builds."""
    kw = dict(backend="cuda", device="cpu")
    states = drifted(24.0, 0.05, ("esp_now", "ble"))
    families = {}
    pool = ProcessPoolExecutor(max_workers=1, mp_context=mp.get_context("spawn"))
    try:
        for label, executor in (("thread", None), ("spawn", pool)):
            rb = rebuilder(True, executor, **kw)
            rb.request(2, states)
            got, deadline = None, time.monotonic() + 120.0
            while got is None and time.monotonic() < deadline:
                got = rb.poll(2)  # the first poll launches
                if got is None:
                    time.sleep(0.02)
            assert got is not None, f"{label} rebuild never adopted"
            families[label] = surface_fields(got)
            assert families[label] == surface_fields(rb.build_sync(rb.last_request)[2])
            rb.shutdown()
    finally:
        pool.shutdown(wait=True)
    assert families["spawn"] == families["thread"]
    assert CD.DENSE_LAUNCHES == CD.FUSED_LAUNCHES == 0
