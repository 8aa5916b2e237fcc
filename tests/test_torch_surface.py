"""Degradation surfaces, port against reference, node by node.

``build_surfaces`` runs in both packages on the same cost model (the
port's converted by ``convert.cost_model_from_reference``) and every
``ProtocolSurface`` field must be equal (``surface_fields`` of
``tests/torch_parity.py``): beam and greedy on the host (numpy, the
default backend for them), and ``batched_dp`` with

* port ``cuda`` on ``device="cpu"`` (the fused kernel's plain version;
  a budgeted build takes the dense one) against reference ``pallas``;
* port ``torch`` (the dense plain version) against reference ``jax``;
* port ``numpy`` against reference ``numpy``,

plain, under an energy budget and over a variant bank with an accuracy
floor. The queries (``lookup``, ``latency_at``, ``best_lookup``,
``switch_points``) are held to the reference's at off-grid points, and
so are ``optimize_chunk_size``, ``refit_link`` and
``ScenarioGrid.degradation_surface(s)``."""

import functools
from dataclasses import fields, replace

import numpy as np
import pytest
import torch

from repro.core import latency as RL
from repro.core import profiles as RP
from repro.core import surface as RSF
from repro.core import sweep as RS
from repro_torch import convert
from repro_torch.core import cuda_dp as CD
from repro_torch.core import surface as PSF
from torch_parity import family_fields, surface_field_names, surface_fields

PT = (1.0, 3.0, 12.0)
LOSS = (0.0, 0.08, None, 0.3)
SIZES = (2, 3, 5)


@functools.lru_cache(maxsize=None)
def models(name="mobilenet_v2"):
    prof = RP.mobilenet_cost_profile() if name == "mobilenet_v2" else RP.resnet50_cost_profile()
    ref = RL.SplitCostModel(profile=prof, devices=(replace(RP.ESP32, active_power_w=0.5),),
                            link=RP.ESP_NOW)
    return ref, convert.cost_model_from_reference(ref)


def links(port):
    base = {p: replace(lk, tx_power_w=0.3, rx_power_w=0.2) for p, lk in RP.PROTOCOLS.items()}
    return {p: convert.link_from_reference(lk) for p, lk in base.items()} if port else base


def build_both(port_kw, ref_kw, name="mobilenet_v2", **kw):
    ref_m, port_m = models(name)
    bank = kw.pop("variants", None)
    pkw = dict(kw)
    if bank is not None:
        kw["variants"] = bank
        pkw["variants"] = [convert.variant_from_reference(v) for v in bank]
    want = RSF.build_surfaces(ref_m, links(False), SIZES, pt_scale=PT, loss_p=LOSS,
                              **ref_kw, **kw)
    got = PSF.build_surfaces(port_m, links(True), SIZES, pt_scale=PT, loss_p=LOSS,
                             **port_kw, **pkw)
    return got, want


CASES = {
    "plain": {},
    "energy budget": {"energy_budget": 1.5},
    "variant bank": {"variants": RP.esp32_variant_bank(), "accuracy_floor": 0.96},
    "bank and budget": {"variants": RP.esp32_variant_bank(), "energy_budget": 2.0},
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("solver", ["batched_beam", "batched_greedy"])
def test_heuristic_surfaces(solver, case):
    got, want = build_both({}, {}, solver=solver, **CASES[case])
    assert family_fields(got) == family_fields(want)
    assert got[5].solver == solver


# (port backend, port dtype, reference backend)
DP_PAIRS = [
    ("cuda", torch.float32, "pallas"),
    ("torch", torch.float32, "jax"),
    ("numpy", torch.float64, "numpy"),
    ("cuda", torch.float64, "numpy"),
]
DP_IDS = [f"{a}-{str(b)[6:]}-vs-{c}" for a, b, c in DP_PAIRS]


@pytest.mark.parametrize("port_backend,dtype,ref_backend", DP_PAIRS, ids=DP_IDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_surfaces(case, port_backend, dtype, ref_backend):
    got, want = build_both(dict(backend=port_backend, device="cpu", dtype=dtype),
                           dict(backend=ref_backend), solver="batched_dp", **CASES[case])
    assert family_fields(got) == family_fields(want)
    assert CD.DENSE_LAUNCHES == CD.FUSED_LAUNCHES == 0
    feasible = [np.isfinite(p.latency_s).any() for s in got.values()
                for p in s.protocols.values()]
    assert any(feasible)


def test_fused_and_dense_surfaces_each_match_their_twin():
    """On ResNet50 the float32 fused build (``cuda``) and the dense one
    (``torch``) each equal their own reference twin; they need not equal
    each other (f32(local) + f32(tx) against f32(local64 + tx64))."""
    for port_backend, ref_backend in (("cuda", "pallas"), ("torch", "jax")):
        got, want = build_both(dict(backend=port_backend, device="cpu"),
                               dict(backend=ref_backend), name="resnet50",
                               solver="batched_dp")
        assert family_fields(got) == family_fields(want)


def test_surface_fields_and_cost_model_round_trip():
    """``cost_model_from_reference`` carries every field of a MobileNet-V2
    cost model with a variant (its tensors are then bit-equal), and
    ``surface_fields`` covers every ``ProtocolSurface`` field and reads a
    surface of either package the same way."""
    ref = RL.SplitCostModel(profile=RP.mobilenet_cost_profile(),
                            devices=(RP.ESP32, replace(RP.ESP32, compute_scale=0.5)) * 2,
                            link=RP.UDP, objective="bottleneck",
                            contention=RL.ContentionModel(3, 0.9),
                            variant=RP.esp32_variant_bank()[2])
    port = convert.cost_model_from_reference(ref)
    for f in fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "profile":
            assert (a.name, a.input_bytes, len(a.layers)) == (b.name, b.input_bytes, len(b.layers))
            assert all(x.__dict__ == y.__dict__ for x, y in zip(a.layers, b.layers))
        elif f.name == "devices":
            assert [d.__dict__ for d in a] == [d.__dict__ for d in b]
        elif f.name in ("link", "contention", "variant"):
            assert a.__dict__ == b.__dict__
        else:
            assert a == b
    assert np.array_equal(port.segment_cost_tensor(4), ref.segment_cost_tensor(4))
    assert np.array_equal(port.transmission_cost_vector(), ref.transmission_cost_vector())

    want = RSF.build_surface(ref, links(False), 3, pt_scale=PT, loss_p=LOSS,
                             variants=RP.esp32_variant_bank())
    got = PSF.build_surface(port, links(True), 3, pt_scale=PT, loss_p=LOSS,
                            variants=[convert.variant_from_reference(v)
                                      for v in RP.esp32_variant_bank()])
    fw = surface_fields(want)
    assert set(fw["udp"]) == surface_field_names()
    assert surface_fields(got) == fw


def off_grid_states(surface, protocol):
    """Query points of one protocol: every node, midpoints, points past
    both ends of both axes and a loss above the clamp."""
    p = surface.protocols[protocol]
    pts, losses = p.packet_time_s, p.loss_p
    xs = list(pts) + [(a + b) / 2 for a, b in zip(pts, pts[1:])] + \
        [pts[0] * 0.5, pts[-1] * 1.7, pts[0] + 0.37 * (pts[1] - pts[0])]
    ls = list(losses) + [(a + b) / 2 for a, b in zip(losses, losses[1:])] + \
        [-0.1, 0.35, 0.95, losses[0] + 0.73 * (losses[1] - losses[0])]
    return [(x, lp) for x in xs for lp in ls]


@pytest.mark.parametrize("solver", ["batched_beam", "batched_dp"])
def test_queries_off_grid(solver):
    kw = {"solver": solver}
    got, want = build_both(dict(backend="numpy") if solver == "batched_dp" else {},
                           {}, variants=RP.esp32_variant_bank(), **kw)
    for n in SIZES:
        g, w = got[n], want[n]
        assert g.n_nodes == w.n_nodes
        for proto in w.protocols:
            assert g.envelope(proto) == w.envelope(proto)
            for pt, lp in off_grid_states(w, proto):
                a, b = g.lookup(proto, pt, lp), w.lookup(proto, pt, lp)
                assert a.__dict__ == b.__dict__, (proto, pt, lp)
                assert g.latency_at(proto, pt, lp) == w.latency_at(proto, pt, lp)
                assert g.in_envelope(proto, pt, lp) == w.in_envelope(proto, pt, lp)
        assert [s.__dict__ for s in g.switch_points()] == \
            [s.__dict__ for s in w.switch_points()]
        assert [s.__dict__ for s in g.switch_points("ble")] == \
            [s.__dict__ for s in w.switch_points("ble")]
        protos = list(w.protocols)
        for i in range(12):
            states = {p: off_grid_states(w, p)[(7 * i + 3 * j) % 40]
                      for j, p in enumerate(protos)}
            a, b = g.best_lookup(states), w.best_lookup(states)
            assert (a is None and b is None) or a.__dict__ == b.__dict__
            assert g.covers(states) == w.covers(states)


def test_chunk_size_and_refit():
    for proto, lk in RP.PROTOCOLS.items():
        plk = convert.link_from_reference(lk)
        for cuts in ([], [4000], [1200, 80000, 37], [250 * 7, 999]):
            for cands in (None, [64, 300, 1000], [lk.mtu_bytes]):
                assert PSF.optimize_chunk_size(plk, cuts, cands) == \
                    RSF.optimize_chunk_size(lk, cuts, cands)
        for pt in (0.0, lk.packet_time_s(), 3.7 * lk.packet_time_s()):
            for loss in (-0.2, 0.0, 0.15, 0.9, 0.99):
                a, b = PSF.refit_link(plk, pt, loss), RSF.refit_link(lk, pt, loss)
                assert a.__dict__ == b.__dict__
        assert PSF._resolve_axes(plk, PT, LOSS) == RSF._resolve_axes(lk, PT, LOSS)
    assert PSF.DEFAULT_PT_SCALES == RSF.DEFAULT_PT_SCALES
    assert PSF.DEFAULT_LOSS_GRID == RSF.DEFAULT_LOSS_GRID


def surface_grid():
    return RS.ScenarioGrid(
        models={"mobilenet_v2": RP.mobilenet_cost_profile()},
        links={p: RP.PROTOCOLS[p] for p in ("udp", "esp_now", "ble")},
        n_devices=(2, 4), loss_p=(None, 0.05, 0.2), rate_scale=(1.0, 0.5, 0.125),
        devices=(RP.ESP32,))


@pytest.mark.parametrize("kw", [{}, {"solver": "batched_greedy"},
                                {"solver": "batched_dp", "backend": "numpy"}],
                         ids=["beam", "greedy", "dp-numpy"])
def test_grid_degradation_surfaces(kw):
    grid = surface_grid()
    pgrid = convert.grid_from_reference(grid)
    rkw = {k: v for k, v in kw.items() if k != "backend"}
    assert family_fields(pgrid.degradation_surfaces(**kw)) == \
        family_fields(grid.degradation_surfaces(**rkw))
    assert family_fields(pgrid.degradation_surfaces(n_devices=(4,), **kw)) == \
        family_fields(grid.degradation_surfaces(n_devices=(4,), **rkw))
    assert surface_fields(pgrid.degradation_surface(**kw)) == \
        surface_fields(grid.degradation_surface(**rkw))


def test_grid_degradation_surface_on_a_mix():
    fast = RL.DeviceProfile("srv", compute_scale=0.05)
    grid = replace(surface_grid(), devices=(), device_mixes={"tail": (RP.ESP32,) * 3 + (fast,)})
    pgrid = convert.grid_from_reference(grid)
    assert surface_fields(pgrid.degradation_surface(n_devices=4, mix="tail")) == \
        surface_fields(grid.degradation_surface(n_devices=4, mix="tail"))
    with pytest.raises(ValueError, match="unknown device mix"):
        pgrid.degradation_surface(mix="other")


def test_plan_surface_is_build_surface():
    from repro_torch.core import planner as PPL

    ref, port = models()
    s = PPL.plan_surface(port, links(True), 3, pt_scale=PT, loss_p=LOSS)
    assert surface_fields(s) == surface_fields(
        RSF.build_surface(ref, links(False), 3, pt_scale=PT, loss_p=LOSS))
