"""The fleet gateway and its QoS statistics (``repro_torch.runtime``)
against the reference's.

A scripted run drives the port's ``FleetGateway`` and the reference's
through the same events (50 sessions over fleets of 2 and 3,
``solver="optimal_dp"``, ``backend="numpy"`` on the port; rebuilds on a
:class:`ManualExecutor`; a clock that ticks once a call, so the QoS
windows hold equal numbers): registration, nominal observes, a token
loop, a drift storm and its rebuild, churn. Every counter of the fleet
snapshot, every session's decisions, meter, adoptions and QoS must be
equal, with zero stale adoptions. Then shedding, ``serve()`` under
asyncio, and ``percentile`` / ``RollingWindow`` / ``QosMonitor`` against
the reference and a numpy oracle."""

import asyncio
import itertools
import math

import numpy as np
import pytest

from repro.core import async_replan as RAR
from repro.core import profiles as RP
from repro.runtime import gateway as RG
from repro.runtime import stats as RST
from repro_torch import convert
from repro_torch.core import async_replan as PAR
from repro_torch.runtime import gateway as PG
from repro_torch.runtime import stats as PST
from torch_parity import decisions, plan_fields, protocols

GRID = {"pt_scale": (1.0, 4.0, 16.0), "loss_p": (0.0, 0.1)}
NBYTES = 5488
# one EWMA step at 5000x lands far off the 16x surface, deep enough that
# the rebuilt surface moves the drifted sessions from ESP-NOW to UDP
STORM = 5000.0


def gateway(port, executor, **kw):
    ref_model = RP.paper_cost_model("mobilenet_v2", "esp_now")
    mod = PG if port else RG
    if port:
        kw.setdefault("backend", "numpy")
    ticks = itertools.count()
    return mod.FleetGateway(
        convert.cost_model_from_reference(ref_model) if port else ref_model,
        protocols(RP.PROTOCOLS, port), kw.pop("fleet_sizes", (2, 3)),
        executor=executor, surface_grid=GRID, clock=lambda: float(next(ticks)), **kw)


def nominal(gw, sid):
    return gw.sessions[sid].meter.link.transmission_latency_s(NBYTES)


def observe_round(gw, sids, factor=1.0):
    for sid in sids:
        gw.submit_observe(sid, NBYTES, nominal(gw, sid) * factor)
    return gw.pump()


def session_state(sess):
    m = sess.meter
    return dict(history=decisions(sess.manager.history), counters=sess.counters(),
                plan=plan_fields(m.plan), hop_seconds=m.hop_seconds, hops=m.hops,
                replans=m.replans, protocol=m.protocol,
                link=convert.link_from_reference(m.link), adoptions=sess.handle.adoptions,
                observes=sess.observes, tokens=sess.tokens,
                violations=sess.adoption_violations())


def scripted_run(port):
    ex = (PAR if port else RAR).ManualExecutor()
    gw = gateway(port, ex, solver="optimal_dp")
    sids = [f"s{i}" for i in range(50)]
    log = []
    for i, sid in enumerate(sids):
        gw.register(sid, 2 + i % 2, bytes_per_token=NBYTES)
    log.append(observe_round(gw, sids))
    for sid in sids[:20]:
        gw.submit_token(sid)
    log.append(gw.pump())
    storm = sids[30:]
    log.append(observe_round(gw, storm, STORM))  # requests queue
    log.append(observe_round(gw, storm, STORM))  # the first poll launches
    log.append((ex.pending(), gw.rebuilder.builds_started))
    ex.run_all()
    log.append(observe_round(gw, storm, STORM))  # adoption round
    for sid in sids[:5]:  # churn mid-run
        gw.drop(sid)
        gw.register(sid, 3, bytes_per_token=NBYTES)
    ex.run_all()
    log.append(observe_round(gw, sids))
    for sid in storm:
        gw.submit_token(sid)
    log.append(gw.pump())
    snap = gw.snapshot(include_sessions=True)
    out = dict(log=log, n_sessions=snap.n_sessions, observes=snap.observes,
               p50=snap.p50_s, p99=snap.p99_s, counters=dict(snap.counters),
               sessions=[(s.session_id, s.n_devices, s.observes, s.p50_s, s.p99_s,
                          dict(s.counters)) for s in snap.sessions],
               state={sid: session_state(s) for sid, s in gw.sessions.items()},
               tokens=gw.token_window.values(), rebuild_errors=gw.rebuild_errors,
               family=sorted(gw.surfaces))
    gw.close()
    return out


def test_scripted_gateway_run_equals_the_references():
    want, got = scripted_run(False), scripted_run(True)
    for key in want:
        assert got[key] == want[key], key
    c = got["counters"]
    assert c["stale_adoption_violations"] == 0 and c["registrations"] == 55
    assert c["builds_started"] >= 1 and c["surface_swaps"] >= 20
    assert c.get("events_shed", 0) == 0 and got["rebuild_errors"] == 0
    moved = [s for s in got["state"].values() if s["replans"]]
    assert moved and all(s["protocol"] == "udp" and s["link"].name == "udp" for s in moved)


def test_gateway_plan_spec_is_the_references():
    ex_ref, ex_port = RAR.ManualExecutor(), PAR.ManualExecutor()
    ref, port = gateway(False, ex_ref), gateway(True, ex_port, backend="numpy")
    assert port.plan_spec.to_json() == ref.plan_spec.to_json()
    assert port.rebuilder.backend == "numpy" and port.rebuilder.device is None
    ref.close()
    port.close()


def test_shedding_is_counted():
    g = gateway(True, PAR.ManualExecutor(), fleet_sizes=(2,), max_pending=8)
    try:
        g.register("a", 2)
        accepted = sum(g.submit_observe("a", NBYTES, 1e-3) for _ in range(20))
        assert accepted == 8 and g.qos.counters["events_shed"] == 12
        assert g.pending == 8 and g.pump() == 8
        assert g.qos.counters["events_processed"] == 8
        assert g.submit_observe("a", NBYTES, 1e-3)  # admission opens again
        g.drop("a")
        assert g.pump() == 1 and g.qos.counters["events_orphaned"] == 1
        assert g.snapshot().counters["events_shed"] == 12
    finally:
        g.close()


def test_serve_pumps_under_asyncio():
    g = gateway(True, PAR.ManualExecutor(), fleet_sizes=(2,))

    async def scenario():
        task = asyncio.create_task(g.serve(batch=8, idle_sleep_s=0.0))
        g.register("a", 2, bytes_per_token=NBYTES)
        for _ in range(20):
            g.submit_observe("a", NBYTES, nominal(g, "a"))
            g.submit_token("a")
        while g.pending:
            await asyncio.sleep(0)
        g.stop()
        await task

    try:
        asyncio.run(scenario())
        assert g.qos.counters["events_processed"] == 40
        assert g.qos.counters["tokens_processed"] == 20
        assert g.sessions["a"].meter.hops == 20
        assert not g._running
    finally:
        g.close()


@pytest.mark.parametrize("n", [1, 2, 3, 7, 100, 257])
def test_percentile_equals_the_reference_and_numpy(n):
    vals = np.random.default_rng(n).exponential(1.0, size=n).tolist()
    for q in (0.0, 25.0, 50.0, 90.0, 99.0, 100.0):
        got = PST.percentile(vals, q)
        assert got == RST.percentile(vals, q)
        assert got == pytest.approx(float(np.percentile(vals, q)), rel=1e-12, abs=0.0)
    w = PST.RollingWindow(maxlen=max(1, n // 2))
    for v in vals:
        w.add(v)
    kept = np.asarray(w.values())
    assert w.count == n and len(kept) == max(1, n // 2)
    assert w.percentiles((50.0, 99.0)) == tuple(PST.percentile(kept, q) for q in (50.0, 99.0))
    assert w.mean() == sum(kept.tolist()) / len(kept)


def test_percentile_rejects_bad_inputs():
    with pytest.raises(ValueError):
        PST.percentile([], 50.0)
    with pytest.raises(ValueError):
        PST.percentile([1.0], 101.0)
    with pytest.raises(ValueError):
        PST.RollingWindow(0)


def test_qos_monitor_equals_the_references():
    runs = []
    rng = np.random.default_rng(4)
    samples = [(f"k{rng.integers(3)}", float(rng.exponential())) for _ in range(60)]
    for mod in (RST, PST):
        q = mod.QosMonitor(key_window=4, global_window=16)
        for key, v in samples:
            q.record(key, v)
            q.bump("n")
        q.drop("k0")
        runs.append((q.key_percentiles("k1"), q.key_percentiles("k0"),
                     q.fleet_percentiles(), q.global_window.count, dict(q.counters),
                     q.window("k0"), sorted(q.window("k2").values())))
    got, want = runs
    assert math.isnan(got[1][0]) and math.isnan(want[1][0])
    assert (got[0], got[2:]) == (want[0], want[2:])
    window = np.asarray(sorted(v for _, v in samples[-16:]))
    assert got[2] == pytest.approx(tuple(np.percentile(window, (50.0, 99.0))),
                                   rel=1e-12, abs=0.0)
