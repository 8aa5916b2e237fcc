"""The port's ``sweep()`` against the reference's, at full model width.

The same grid (MobileNet-V2, L = 54, and ResNet50, L = 52, with the
paper's ESP32 and protocols) goes through both packages: the port's
through ``repro_torch.convert.grid_from_reference``. Each port backend
is held to the reference backend with the same arithmetic, and every
row must be exactly equal:

* port ``torch`` (float32, dense plain version on a materialised C) vs
  reference ``jax``;
* port ``numpy``, ``torch`` and ``cuda`` in float64 vs reference ``numpy``;
* port ``cuda`` on ``device="cpu"`` (the fused kernel's plain version;
  budgeted groups take the dense one) vs reference ``pallas``.

Grids cover device mixes, energy budgets and compression factors."""

import functools
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.core import profiles as RP
from repro.core import sweep as RS
from repro.core.latency import DeviceProfile
from repro_torch import convert
from repro_torch.core import cuda_dp as CD
from repro_torch.core import sweep as PS

MODELS = {"mobilenet_v2": RP.mobilenet_cost_profile(),
          "resnet50": RP.resnet50_cost_profile()}
TWO_LINKS = {p: RP.PROTOCOLS[p] for p in ("udp", "esp_now")}
POWERED = replace(RP.ESP32, active_power_w=0.5)


def _grid(name):
    if name == "base":  # 2 models x 4 protocols x 4 fleet sizes x 2 x 2 = 128
        return RS.ScenarioGrid(models=MODELS, links=dict(RP.PROTOCOLS),
                               n_devices=(2, 3, 4, 5), loss_p=(None, 0.1),
                               rate_scale=(1.0, 0.25), devices=(RP.ESP32,))
    if name == "mixes":  # 2 mixes x 2 protocols x 4 x 2 x 2 = 64
        fast = DeviceProfile("srv", compute_scale=0.05)
        return RS.ScenarioGrid(
            models={"mobilenet_v2": MODELS["mobilenet_v2"]}, links=TWO_LINKS,
            n_devices=(2, 3, 4, 5), loss_p=(None, 0.2), rate_scale=(1.0, 0.5),
            devices=(RP.ESP32,),
            device_mixes={"srv_tail": (RP.ESP32,) * 4 + (fast,)})
    if name == "budgets":  # 2 models x 2 protocols x 3 x 2 x 3 budgets = 72
        links = {p: replace(lk, tx_power_w=0.3, rx_power_w=0.2)
                 for p, lk in TWO_LINKS.items()}
        return RS.ScenarioGrid(models=MODELS, links=links, n_devices=(2, 3, 5),
                               rate_scale=(1.0, 0.5), devices=(POWERED,),
                               energy_budgets=(None, 1.0, 0.4))
    if name == "compression":  # 2 protocols x 2 x 2 x 3 factors, 2 models = 48
        return RS.ScenarioGrid(
            models=MODELS, links={p: RP.PROTOCOLS[p] for p in ("udp", "ble")},
            n_devices=(2, 4), rate_scale=(1.0, 0.5), devices=(RP.ESP32,),
            compression_factors=(1.0, 2.0, 4.0),
            variant_encoder_s_per_byte=2e-8)
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def reference(name, backend):
    return RS.sweep(_grid(name), backend=backend)


def assert_rows_equal(port, ref):
    assert port.n_scenarios == ref.n_scenarios
    for p, r in zip(port.rows, ref.rows):
        assert p.scenario.describe() == r.scenario.describe()
        assert (p.splits, p.feasible) == (r.splits, r.feasible), p.scenario
        for f in ("objective_cost_s", "total_latency_s", "device_s",
                  "transmission_s", "accuracy_proxy"):
            assert getattr(p, f) == getattr(r, f), (f, p.scenario)


# (port backend, port dtype, reference backend)
PAIRS = [
    ("torch", torch.float32, "jax"),
    ("numpy", torch.float64, "numpy"),
    ("torch", torch.float64, "numpy"),
    ("cuda", torch.float64, "numpy"),
    ("cuda", torch.float32, "pallas"),
]


@pytest.mark.parametrize("port_backend,dtype,ref_backend", PAIRS,
                         ids=[f"{a}-{str(b)[6:]}-vs-{c}" for a, b, c in PAIRS])
@pytest.mark.parametrize("name", ["base", "mixes", "budgets", "compression"])
def test_sweep_matches_reference(name, port_backend, dtype, ref_backend):
    grid = convert.grid_from_reference(_grid(name))
    got = PS.sweep(grid, backend=port_backend, device="cpu", dtype=dtype)
    assert got.backend == port_backend
    assert_rows_equal(got, reference(name, ref_backend))
    assert CD.DENSE_LAUNCHES == CD.FUSED_LAUNCHES == 0


def test_budget_grid_binds():
    """The budget axis really masks segments: some budgeted plan differs
    from its unconstrained twin."""
    plans = {}
    for r in reference("budgets", "numpy").rows:
        key = replace(r.scenario, energy_budget=None)
        plans.setdefault(key, set()).add((r.splits, r.feasible))
    assert any(len(p) > 1 for p in plans.values())


def test_result_api():
    grid = convert.grid_from_reference(_grid("base"))
    res = PS.sweep(grid, backend="numpy")
    want = reference("base", "numpy").best(model="resnet50", n_devices=5)
    best = res.best(model="resnet50", n_devices=5)
    assert best.scenario.describe() == want.scenario.describe()
    assert best.total_latency_s == want.total_latency_s
    assert res.to_json().startswith('{"solver": "batched_dp"')
    assert len(res.to_dicts()) == grid.size == 128
    assert np.isfinite(res.scenarios_per_sec)
