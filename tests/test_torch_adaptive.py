"""Runtime replanning (``repro_torch.core.adaptive``) against the
reference's, decision by decision.

The port's and the reference's managers take the same scripted trace of
hop observations (``backend="numpy"`` on the port, the reference's
default): nominal hops, a storm at 5000x nominal on ESP-NOW and 30x on
BLE with retries, then calm again (the managers move to UDP and back),
with the rebuild jobs of a :class:`ManualExecutor` run at fixed points. Their decision histories,
counters, adopted surfaces and current plans must be equal with ``==``:
synchronously, with ``async_rebuild`` under both off-surface policies,
over a variant bank with an accuracy floor, under an energy budget, on
the legacy re-solve path and with beam search; then a fleet of managers
sharing one rebuilder (``fleet_managers``). ``surface_parity_report`` is
empty, and ``backend="torch"`` on ``device="cpu"`` runs the dense
kernel's plain version through the same manager."""

from dataclasses import replace

import pytest
import torch

from repro.core import adaptive as RA
from repro.core import async_replan as RAR
from repro.core import profiles as RP
from repro_torch import convert
from repro_torch.core import adaptive as PA
from repro_torch.core import async_replan as PAR
from repro_torch.core import cuda_dp as CD
from torch_parity import decisions, plan_fields, protocols, surface_fields

GRID = {"pt_scale": (1.0, 4.0, 16.0), "loss_p": (0.0, 0.1)}
NBYTES = 5488
# (protocol, factor x nominal hop latency, retries); "run" drains the
# executor's queued rebuilds
TRACE = ([("esp_now", 1.0, 0)] * 4 + [("esp_now", 5000.0, 0)] * 8 + ["run"]
         + [("esp_now", 5000.0, 1)] * 4 + [("ble", 30.0, 3)] * 6 + ["run"]
         + [("esp_now", 1.0, 0)] * 30 + ["run"]
         + [("esp_now", 1.0, 0), ("ble", 1.0, 0)] * 4)


def cost_model(port, powered=False):
    ref = RP.paper_cost_model("mobilenet_v2", "esp_now")
    if powered:
        ref = replace(ref, devices=(replace(RP.ESP32, active_power_w=0.5),))
    return convert.cost_model_from_reference(ref) if port else ref


def links(port, powered=False):
    base = dict(RP.PROTOCOLS)
    if powered:
        base = {p: replace(lk, tx_power_w=0.3, rx_power_w=0.2) for p, lk in base.items()}
    return protocols(base, port)


def bank(port):
    b = RP.esp32_variant_bank()
    return tuple(convert.variant_from_reference(v) for v in b) if port else b


CASES = {
    "sync": dict(solver="optimal_dp"),
    "async exact": dict(solver="optimal_dp", executor=True),
    "async stale": dict(solver="optimal_dp", executor=True, offsurface_fallback="stale"),
    "variant bank": dict(solver="optimal_dp", executor=True, variants=True,
                         accuracy_floor=0.96),
    "energy budget": dict(solver="optimal_dp", executor=True, energy_budget=1.5,
                          powered=True),
    "legacy re-solve": dict(solver="optimal_dp", surface=None),
    "beam": dict(solver="beam", executor=True),
}


def manager(port, n_devices, case, **extra):
    kw = dict(CASES[case])
    powered = kw.pop("powered", False)
    ex = None
    if kw.pop("executor", False):
        ex = (PAR if port else RAR).ManualExecutor()
        kw["async_rebuild"] = ex
    if kw.pop("variants", False):
        kw["variants"] = bank(port)
    if port:
        kw.setdefault("backend", "numpy")
        kw.update(extra)
    mod = PA if port else RA
    m = mod.AdaptiveSplitManager(cost_model=cost_model(port, powered),
                                 protocols=links(port, powered), n_devices=n_devices,
                                 surface_grid=GRID, **kw)
    return m, ex


def drive(managers, ex, trace=TRACE):
    """Feed ``trace`` to ``managers`` in turn (one event each)."""
    for event in trace:
        if event == "run":
            if ex is not None:
                ex.run_all()
            continue
        proto, factor, retries = event
        lat = factor * RP.PROTOCOLS[proto].transmission_latency_s(NBYTES)
        for m in managers:
            m.observe(proto, NBYTES, lat, retries)


def outcome(m):
    est = {n: (e.packet_time_estimate, e.loss_estimate, e.n_obs)
           for n, e in m.estimators.items()}
    surface = None if m.surface is None else surface_fields(m.surface)
    plan = m.current_plan()
    return dict(history=decisions(m.history), counters=m.counters(), estimators=est,
                surface=surface, plan=None if plan is None else plan_fields(plan))


def test_link_estimator_equals_the_references():
    for name, lk in RP.PROTOCOLS.items():
        ref, port = RA.LinkEstimator(lk), PA.LinkEstimator(convert.link_from_reference(lk))
        for k, (nbytes, factor, retries) in enumerate(
                [(5488, 1.0, 0), (100, 3.0, 2), (70_000, 0.5, 0), (1, 40.0, 7)] * 3):
            lat = factor * lk.transmission_latency_s(nbytes)
            ref.observe_hop(nbytes, lat, retries)
            port.observe_hop(nbytes, lat, retries)
            assert (port.packet_time_estimate, port.loss_estimate, port.n_obs) == \
                (ref.packet_time_estimate, ref.loss_estimate, ref.n_obs), (name, k)
        got, want = port.current_profile(), ref.current_profile()
        assert got == convert.link_from_reference(want)


@pytest.mark.parametrize("n_devices", [2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decisions_equal_the_references(case, n_devices):
    runs = []
    for port in (False, True):
        m, ex = manager(port, n_devices, case)
        drive([m], ex)
        runs.append(outcome(m))
        m.close()
    want, got = runs
    for key in want:
        assert got[key] == want[key], key
    assert len(got["history"]) >= 2, "the trace never made the manager replan"
    if CASES[case].get("executor"):
        assert got["counters"]["rebuild_requests"] >= 1


def test_fleet_managers_equal_the_references():
    runs = []
    for port in (False, True):
        ex = (PAR if port else RAR).ManualExecutor()
        mod = PA if port else RA
        kw = dict(backend="numpy") if port else {}
        fleet = mod.fleet_managers(cost_model(port), links(port), (2, 3, 5, 3),
                                   solver="optimal_dp", surface_grid=GRID,
                                   async_rebuild=ex, **kw)
        drive(list(fleet.values()), ex)
        rb = next(iter(fleet.values())).rebuilder
        runs.append(({n: outcome(m) for n, m in fleet.items()},
                     (rb.generation, rb.builds_started, rb.builds_completed,
                      rb.requests, rb.requests_coalesced)))
        assert all(m.rebuilder is rb for m in fleet.values())
        rb.shutdown()
    assert list(runs[1][0]) == [2, 3, 5]
    assert runs[1] == runs[0]
    assert runs[1][1][1] >= 1  # the fleet's drift was rebuilt


@pytest.mark.parametrize("case", ["sync", "variant bank", "energy budget"])
def test_surface_parity_report_is_empty(case):
    ref, _ = manager(False, 3, case)
    port, _ = manager(True, 3, case)
    assert RA.surface_parity_report(ref) == []
    assert PA.surface_parity_report(port) == []


def test_the_dense_plain_version_runs_through_the_manager():
    """``backend="torch"`` on ``device="cpu"``: the surface, the rebuilds
    and the exact re-solves all take the dense kernel's plain version;
    in float64 every decision equals the numpy manager's. Nothing
    launches a kernel."""
    CD.reset_launch_counts()
    runs = []
    for extra in (dict(backend="numpy"),
                  dict(backend="torch", device="cpu", dtype=torch.float64)):
        m, ex = manager(True, 3, "async exact", **extra)
        drive([m], ex)
        runs.append(outcome(m))
        assert m.rebuilder.backend == extra["backend"]
        assert m.rebuilder.device == extra.get("device")
    assert runs[1] == runs[0]
    f32, ex = manager(True, 3, "sync", backend="torch", device="cpu")
    drive([f32], ex)
    assert f32.history and f32.surface.solver == "batched_dp"
    assert (CD.DENSE_LAUNCHES, CD.FUSED_LAUNCHES) == (0, 0)


def test_one_backend_per_manager():
    with pytest.raises(ValueError, match="one backend"):
        PA.AdaptiveSplitManager(cost_model=cost_model(True), protocols=links(True),
                                n_devices=2, solver="optimal_dp", backend="numpy",
                                surface_grid={**GRID, "backend": "torch"})
    m = PA.AdaptiveSplitManager(cost_model=cost_model(True), protocols=links(True),
                                n_devices=2, solver="optimal_dp", device="cpu",
                                surface_grid={**GRID, "backend": "torch"})
    assert m.backend == "torch" and m.surface_spec().backend == "torch"


def test_the_manager_solves_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PA.AdaptiveSplitManager(cost_model=cost_model(True), protocols=links(True),
                                n_devices=2, solver="optimal_dp", surface_grid=GRID)
    # beam and greedy are host algorithms: None resolves to numpy for them
    m = PA.AdaptiveSplitManager(cost_model=cost_model(True), protocols=links(True),
                                n_devices=2, solver="beam", surface_grid=GRID)
    assert m.surface.solver == "batched_beam"


def test_reference_spec_of_a_manager_matches():
    """A manager's ``surface_spec`` writes the reference manager's JSON
    once the backend is named."""
    ref, _ = manager(False, 2, "variant bank")
    port, _ = manager(True, 2, "variant bank")
    assert port.surface_spec().to_json() == ref.surface_spec().to_json()
