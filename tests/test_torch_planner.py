"""The port's planner against the reference's, plan by plan.

``plan_split`` (every scalar solver and the batched engines),
``plan_split_batch`` (heterogeneous fleet sizes, an energy budget, a
variant bank with an accuracy floor) and ``compare_solvers`` run on
MobileNet-V2 and ResNet50 cost models in both packages; the port's on
models converted by ``repro_torch.convert.cost_model_from_reference``.
Every ``SplitPlan`` field but ``planner_time_s`` must be equal, read
through ``convert.plan_from_reference``. The DP pairs: port ``numpy``,
and port ``torch`` / ``cuda`` on ``device="cpu"`` in float64, against
reference ``numpy``; port ``torch`` and ``cuda`` in float32 (both the
dense plain version on the CPU) against reference ``jax``."""

import functools
from dataclasses import replace

import pytest
import torch

from repro.core import latency as RL
from repro.core import planner as RPL
from repro.core import profiles as RP
from repro_torch import convert
from repro_torch.core import cuda_dp as CD
from repro_torch.core import planner as PPL
from torch_parity import plan_fields

SCALAR = ("beam", "greedy", "first_fit", "random_fit", "brute_force", "optimal_dp")
BATCHED = ("batched_dp", "batched_beam", "batched_greedy")


@functools.lru_cache(maxsize=None)
def model(name="mobilenet_v2", protocol="esp_now", objective="sum", powered=False):
    dev, link = RP.ESP32, RP.PROTOCOLS[protocol]
    if powered:
        dev = replace(dev, active_power_w=0.5)
        link = replace(link, tx_power_w=0.3, rx_power_w=0.2)
    prof = RP.mobilenet_cost_profile() if name == "mobilenet_v2" else RP.resnet50_cost_profile()
    ref = RL.SplitCostModel(profile=prof, devices=(dev,), link=link, objective=objective)
    return ref, convert.cost_model_from_reference(ref)


def assert_plans_equal(port, ref):
    assert [plan_fields(p) for p in port] == [plan_fields(r) for r in ref]


@pytest.mark.parametrize("objective", ["sum", "bottleneck"])
@pytest.mark.parametrize("N", [2, 4])
@pytest.mark.parametrize("solver", SCALAR + BATCHED)
def test_plan_split(solver, N, objective):
    ref, port = model(objective=objective)
    kw = {"backend": "numpy"} if solver == "batched_dp" else {}
    assert_plans_equal([PPL.plan_split(port, N, solver=solver, **kw)],
                       [RPL.plan_split(ref, N, solver=solver)])


@pytest.mark.parametrize("solver", ["beam", "optimal_dp", "batched_dp", "batched_beam"])
def test_plan_split_with_budget_and_variants(solver):
    ref, port = model(powered=True)
    bank = RP.esp32_variant_bank()
    pbank = [convert.variant_from_reference(v) for v in bank]
    kw = {"backend": "numpy"} if solver == "batched_dp" else {}
    got = PPL.plan_split(port, 3, solver=solver, energy_budget=2.0, variants=pbank,
                         accuracy_floor=0.96, **kw)
    want = RPL.plan_split(ref, 3, solver=solver, energy_budget=2.0, variants=bank,
                          accuracy_floor=0.96)
    assert_plans_equal([got], [want])
    assert want.variant in (0, 1)


def fleet(name="mobilenet_v2", count=16):
    """``count`` cost models of one graph over the four protocols and
    rising loss, with fleets of 2-5 as a per-model list."""
    protos = list(RP.PROTOCOLS)
    refs, ports, ns = [], [], []
    for i in range(count):
        ref, _ = model(name, protos[i % 4], powered=True)
        ref = replace(ref, link=replace(ref.link, loss_p=0.03 * (i // 4)))
        refs.append(ref)
        ports.append(convert.cost_model_from_reference(ref))
        ns.append(2 + i % 4)
    return refs, ports, ns


# (port backend, port dtype, reference backend)
DP_PAIRS = [
    ("numpy", torch.float64, "numpy"),
    ("torch", torch.float64, "numpy"),
    ("cuda", torch.float64, "numpy"),
    ("torch", torch.float32, "jax"),
    ("cuda", torch.float32, "jax"),
]
DP_IDS = [f"{a}-{str(b)[6:]}-vs-{c}" for a, b, c in DP_PAIRS]
BATCH_CASES = {
    "fleets": {},
    "one fleet size": {"n": 4},
    "energy budget": {"energy_budget": 1.2},
    "budget per model": {"energy_budget": [0.9, 1.2, 1.5, 2.5] * 4},
    "variant bank": {"variants": True, "accuracy_floor": 0.96},
    "variants and budget": {"variants": True, "energy_budget": 1.5},
}


def batch_kwargs(case, port):
    kw = dict(BATCH_CASES[case])
    if kw.pop("variants", False):
        bank = RP.esp32_variant_bank()
        kw["variants"] = [convert.variant_from_reference(v) for v in bank] if port else bank
    return kw


@pytest.mark.parametrize("port_backend,dtype,ref_backend", DP_PAIRS, ids=DP_IDS)
@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_plan_split_batch(case, port_backend, dtype, ref_backend):
    refs, ports, ns = fleet()
    pkw, rkw = batch_kwargs(case, True), batch_kwargs(case, False)
    n = pkw.pop("n", ns)
    rkw.pop("n", None)
    want = RPL.plan_split_batch(refs, n, backend=ref_backend, **rkw)
    got = PPL.plan_split_batch(ports, n, backend=port_backend, device="cpu",
                               dtype=dtype, **pkw)
    assert_plans_equal(got, want)
    assert any(p.total_latency_s < float("inf") for p in want)
    assert CD.DENSE_LAUNCHES == CD.FUSED_LAUNCHES == 0


@pytest.mark.parametrize("solver", ["batched_beam", "batched_greedy"])
def test_plan_split_batch_heuristics(solver):
    refs, ports, ns = fleet("resnet50", count=8)
    kw = dict(solver=solver, energy_budget=2.0)
    assert_plans_equal(PPL.plan_split_batch(ports, ns[:8], **kw),
                       RPL.plan_split_batch(refs, ns[:8], **kw))


def test_plan_split_batch_normalises_fleet_sizes():
    """A numpy integer or array of fleet sizes plans as the ints do."""
    import numpy as np

    refs, ports, ns = fleet(count=4)
    want = RPL.plan_split_batch(refs, ns, backend="numpy")
    assert_plans_equal(PPL.plan_split_batch(ports, np.array(ns), backend="numpy"), want)
    assert_plans_equal(PPL.plan_split_batch(ports, np.int64(3), backend="numpy"),
                       RPL.plan_split_batch(refs, 3, backend="numpy"))
    assert PPL.plan_split_batch([], 3) == []


@pytest.mark.parametrize("name", ["mobilenet_v2", "resnet50"])
@pytest.mark.parametrize("N", [2, 3])
def test_compare_solvers(name, N):
    ref, port = model(name)
    solvers = SCALAR
    got = PPL.compare_solvers(port, N, solvers=solvers, random_fit={"trials": 8, "seed": 2})
    want = RPL.compare_solvers(ref, N, solvers=solvers, random_fit={"trials": 8, "seed": 2})
    assert list(got) == list(want) == list(solvers)
    assert_plans_equal(list(got.values()), list(want.values()))
    assert got["brute_force"].objective_cost_s == got["optimal_dp"].objective_cost_s


def test_plans_from_batched_and_uniform_split():
    from repro.core import sweep as RS
    from repro_torch.core import sweep as PS

    refs, ports, ns = fleet(count=8)
    C = PS.stack_cost_tensors(ports, ns)
    res_p = PS.solve_batched(C, n_devices=ns, backend="numpy")
    res_r = RS.solve_batched(C, n_devices=ns)
    assert_plans_equal(PPL.plans_from_batched(ports, res_p, ns, nodes_expanded=7),
                       RPL.plans_from_batched(refs, res_r, ns, nodes_expanded=7))
    for L in (10, 52, 54):
        for n in (1, 2, 3, 5):
            assert PPL.uniform_split(L, n) == RPL.uniform_split(L, n)
