"""The paper's solvers and the batched solve family, port against reference.

The same inputs go through both packages in one process and the results
must be equal (``==`` on splits, costs, feasibility and
``nodes_expanded``; wall times left out):

* the scalar solvers of ``SOLVERS`` on one pure-Python ``cost_fn`` (a
  seeded table, L <= 12, N <= 4) and on MobileNet-V2 (L 54, N 2-4), each
  side then pricing with its own package's ``cost_segment_fn()`` of the
  same converted cost model; with an energy budget and with a variant
  bank under an accuracy floor;
* the batched heuristics on one seeded numpy ``C`` with ~15% +inf;
* ``solve_batched``, ``solve_multi_channel`` and ``solve_variant_bank``:
  port ``numpy``, and port ``torch`` / ``cuda`` on ``device="cpu"`` in
  float64, against reference ``numpy``; port ``torch`` in float32
  against reference ``jax``;
* ``sweep`` with the batched heuristics, ``to_csv``, ``pareto``,
  ``sweep_scalar`` and ``parity_report``.

Scalar results are compared with scalar ones and batched with batched,
never across: Python 3.12's compensated ``sum()`` makes the two differ
in the reference itself."""

import functools
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.core import latency as RL
from repro.core import profiles as RP
from repro.core import solvers as RSV
from repro.core import sweep as RS
from repro_torch import convert
from repro_torch.core import cuda_dp as CD
from repro_torch.core import solvers as PSV
from repro_torch.core import sweep as PS
from torch_parity import batched_fields, row_fields, solver_fields

SOLVER_NAMES = sorted(RSV.SOLVERS)
assert SOLVER_NAMES == sorted(PSV.SOLVERS)


def table_cost_fn(L, N, seed):
    """A pure-Python cost_fn over a seeded (N, L, L) table: integers / 8
    (exact ties), ~15% +inf."""
    rng = np.random.RandomState(seed)
    tab = rng.randint(1, 60, size=(N + 1, L + 1, L + 1)) / 8.0
    tab[rng.random_sample(tab.shape) < 0.15] = np.inf
    tab = tab.tolist()

    def fn(a, b, k):
        return tab[k][a][b]

    return fn


def run_both(name, ref_args, port_args, **kwargs):
    ref = RSV.SOLVERS[name](*ref_args, **kwargs)
    port = PSV.SOLVERS[name](*port_args, **kwargs)
    assert solver_fields(port) == solver_fields(ref)
    return ref


@pytest.mark.parametrize("combine", ["sum", "max"])
@pytest.mark.parametrize("L,N", [(6, 2), (9, 3), (12, 4)])
@pytest.mark.parametrize("name", SOLVER_NAMES)
def test_scalar_solver_on_a_table(name, L, N, combine):
    fn = table_cost_fn(L, N, seed=L * 10 + N)
    kwargs = {"trials": 25, "seed": 3} if name == "random_fit" else {}
    run_both(name, (fn, L, N), (fn, L, N), combine=combine, **kwargs)


@functools.lru_cache(maxsize=None)
def mobilenet(objective="sum", powered=False, protocol="esp_now"):
    dev, link = RP.ESP32, RP.PROTOCOLS[protocol]
    if powered:
        dev = replace(dev, active_power_w=0.5)
        link = replace(link, tx_power_w=0.3, rx_power_w=0.2)
    ref = RL.SplitCostModel(profile=RP.mobilenet_cost_profile(), devices=(dev,),
                            link=link, objective=objective)
    return ref, convert.cost_model_from_reference(ref)


@pytest.mark.parametrize("objective", ["sum", "bottleneck"])
@pytest.mark.parametrize("N", [2, 3, 4])
@pytest.mark.parametrize("name", SOLVER_NAMES)
def test_scalar_solver_on_mobilenet(name, N, objective):
    ref, port = mobilenet(objective)
    combine = "max" if objective == "bottleneck" else "sum"
    L = ref.profile.num_layers
    res = run_both(name, (ref.cost_segment_fn(), L, N),
                   (port.cost_segment_fn(), L, N), combine=combine)
    assert res.feasible


def binding_budget(ref):
    """0.9 x the largest segment energy of the unconstrained 3-device
    optimum: that plan is then over budget."""
    L = ref.profile.num_layers
    free = RSV.optimal_dp(ref.cost_segment_fn(), L, 3)
    bounds = [0, *free.splits, L]
    efn = ref.energy_segment_fn()
    return 0.9 * max(efn(bounds[i] + 1, bounds[i + 1], i + 1) for i in range(3))


@pytest.mark.parametrize("name", SOLVER_NAMES)
def test_scalar_solver_under_an_energy_budget(name):
    """Each side masks with its own energy model of the same cost model."""
    ref, port = mobilenet(powered=True)
    L = ref.profile.num_layers
    budget = binding_budget(ref)
    r = RSV.SOLVERS[name](ref.cost_segment_fn(), L, 3,
                          energy_fn=ref.energy_segment_fn(), energy_budget=budget)
    p = PSV.SOLVERS[name](port.cost_segment_fn(), L, 3,
                          energy_fn=port.energy_segment_fn(), energy_budget=budget)
    assert solver_fields(p) == solver_fields(r)
    if name == "optimal_dp":
        assert r.splits != RSV.optimal_dp(ref.cost_segment_fn(), L, 3).splits


@pytest.mark.parametrize("floor", [None, 0.96])
@pytest.mark.parametrize("name", SOLVER_NAMES)
def test_scalar_solver_over_a_variant_bank(name, floor):
    ref, port = mobilenet(powered=True)
    L = ref.profile.num_layers
    bank = RP.esp32_variant_bank()
    insts = {}
    for pkg, SV, m, conv in (("ref", RSV, ref, lambda v: v),
                             ("port", PSV, port, convert.variant_from_reference)):
        models = [replace(m, variant=conv(v)) for v in bank]
        insts[pkg] = [SV.VariantInstance(cost_fn=mm.cost_segment_fn(),
                                         energy_fn=mm.energy_segment_fn(),
                                         accuracy_proxy=v.accuracy_proxy)
                      for mm, v in zip(models, bank)]
    kw = dict(energy_budget=2.0, accuracy_floor=floor)
    r = RSV.SOLVERS[name](None, L, 3, variants=insts["ref"], **kw)
    p = PSV.SOLVERS[name](None, L, 3, variants=insts["port"], **kw)
    assert solver_fields(p) == solver_fields(r)
    if floor is not None and r.feasible:
        assert bank[r.variant].accuracy_proxy >= floor


def test_scalar_helpers():
    fn = table_cost_fn(10, 3, seed=5)
    for splits in [(2, 6), (3, 3), (1, 9), (9, 1)]:
        for combine in ("sum", "max"):
            assert PSV.total_cost(fn, splits, 10, combine) == \
                RSV.total_cost(fn, splits, 10, combine)
        assert PSV.total_energy(fn, splits, 10) == RSV.total_energy(fn, splits, 10)
    assert PSV._min_devices_suffix(fn, 10) == RSV._min_devices_suffix(fn, 10)
    masked = (PSV.budget_masked(fn, fn, 3.0), RSV.budget_masked(fn, fn, 3.0))
    assert [masked[0](a, b, 2) for a in range(1, 10) for b in range(a, 10)] == \
        [masked[1](a, b, 2) for a in range(1, 10) for b in range(a, 10)]
    assert PSV.budget_masked(fn, None, 3.0) is fn


# ---------------------------------------------------------------------------
# Batched heuristics on one numpy tensor
# ---------------------------------------------------------------------------


def seeded_C(S=48, N=4, L=10, seed=0):
    rng = np.random.RandomState(seed)
    C = rng.randint(1, 80, size=(S, N, L, L)) / 8.0
    C[rng.random_sample(C.shape) < 0.15] = np.inf
    return C, rng.randint(1, N + 1, size=S)


def assert_batched_equal(port, ref, same_backend=True):
    p, r = batched_fields(port), batched_fields(ref)
    if not same_backend:
        p.pop("backend"), r.pop("backend")
    assert p == r


HEURISTIC_CASES = {
    "plain": {},
    "per-scenario fleets": {"per_scenario": True},
    "need_table": {"need": True},
    "no lookahead": {"feasibility_lookahead": False},
    "fleets, no lookahead": {"per_scenario": True, "feasibility_lookahead": False},
}


@pytest.mark.parametrize("combine", ["sum", "max"])
@pytest.mark.parametrize("case", sorted(HEURISTIC_CASES))
@pytest.mark.parametrize("solver", ["batched_beam_search", "batched_greedy_search"])
def test_batched_heuristic(solver, case, combine):
    C, ns = seeded_C(seed=len(case))
    opts = dict(HEURISTIC_CASES[case])
    kwargs = {"combine": combine}
    if "feasibility_lookahead" in opts:
        kwargs["feasibility_lookahead"] = opts["feasibility_lookahead"]
    if opts.get("per_scenario"):
        kwargs["n_devices"] = ns
    if opts.get("need"):
        kwargs["need_table"] = RS._min_devices_suffix_batched(C)
    if solver == "batched_beam_search":
        kwargs["beam_width"] = 3
    ref = getattr(RS, solver)(C, **kwargs)
    port = getattr(PS, solver)(C, **kwargs)
    assert_batched_equal(port, ref)
    assert ref.feasible.any() and not ref.feasible.all()


@pytest.mark.parametrize("fleet_sizes", [None, (4, 2), (1, 3)])
@pytest.mark.parametrize("combine", ["sum", "max"])
@pytest.mark.parametrize("solver", ["batched_beam_search_all_k",
                                    "batched_greedy_search_all_k"])
def test_batched_heuristic_all_k(solver, combine, fleet_sizes):
    C, _ = seeded_C(seed=11)
    ref = getattr(RS, solver)(C, combine=combine, fleet_sizes=fleet_sizes)
    port = getattr(PS, solver)(C, combine=combine, fleet_sizes=fleet_sizes)
    assert list(port) == list(ref)
    for n in ref:
        assert_batched_equal(port[n], ref[n])


def test_tensor_utilities():
    C, ns = seeded_C(seed=3)
    assert np.array_equal(PS._min_devices_suffix_batched(C),
                          RS._min_devices_suffix_batched(C))
    cand = np.array([[1, 2, 3], [3, 5, 9], [2, 2, 7], [4, 8, 9]])
    for combine in ("sum", "max"):
        assert np.array_equal(PS.batched_total_cost(C, cand, combine),
                              RS.batched_total_cost(C, cand, combine))
        splits = np.tile(np.array([[2, 5, 8]]), (C.shape[0], 1))
        assert np.array_equal(
            PS._per_scenario_total_cost(C, splits, combine, ns),
            RS._per_scenario_total_cost(C, splits, combine, ns))
    assert PS.SCALAR_ORACLES == RS.SCALAR_ORACLES
    assert sorted(PS.BATCHED_SOLVERS) == sorted(RS.BATCHED_SOLVERS)


# ---------------------------------------------------------------------------
# The solve family
# ---------------------------------------------------------------------------


# (port backend, port dtype, reference backend)
DP_PAIRS = [
    ("numpy", torch.float64, "numpy"),
    ("torch", torch.float64, "numpy"),
    ("cuda", torch.float64, "numpy"),
    ("torch", torch.float32, "jax"),
]
DP_IDS = [f"{a}-{str(b)[6:]}-vs-{c}" for a, b, c in DP_PAIRS]


def port_kw(backend, dtype):
    return dict(backend=backend, device="cpu", dtype=dtype)


@pytest.mark.parametrize("port_backend,dtype,ref_backend", DP_PAIRS, ids=DP_IDS)
@pytest.mark.parametrize("fleets", ["full", "per-scenario"])
def test_solve_batched_dp(fleets, port_backend, dtype, ref_backend):
    C, ns = seeded_C(S=64, N=5, L=12, seed=21)
    n = ns if fleets == "per-scenario" else None
    ref = RS.solve_batched(C, backend=ref_backend, n_devices=n)
    port = PS.solve_batched(C, n_devices=n, **port_kw(port_backend, dtype))
    assert port.backend == port_backend
    assert_batched_equal(port, ref, same_backend=False)
    assert CD.DENSE_LAUNCHES == CD.FUSED_LAUNCHES == 0


@pytest.mark.parametrize("solver", ["batched_beam", "batched_greedy"])
def test_solve_batched_heuristics(solver):
    C, ns = seeded_C(S=32, N=4, L=9, seed=8)
    kw = {"beam_width": 4} if solver == "batched_beam" else {}
    ref = RS.solve_batched(C, solver=solver, combine="max", n_devices=ns, **kw)
    for backend in (None, "numpy"):
        port = PS.solve_batched(C, solver=solver, combine="max", n_devices=ns,
                                backend=backend, **kw)
        assert_batched_equal(port, ref)


@functools.lru_cache(maxsize=None)
def channel_stacks():
    """(reference, port) latency + energy stacks of 12 MobileNet-V2 cost
    models over three protocols and fleets of 2-5; each package stacks its
    own converted models."""
    ref_models, ns = [], []
    for i, proto in enumerate(["udp", "esp_now", "ble"] * 4):
        link = replace(RP.PROTOCOLS[proto], tx_power_w=0.3, rx_power_w=0.2,
                       loss_p=0.02 * i)
        ref_models.append(RL.SplitCostModel(
            profile=RP.mobilenet_cost_profile(),
            devices=(replace(RP.ESP32, active_power_w=0.5),), link=link))
        ns.append(2 + i % 4)
    port_models = [convert.cost_model_from_reference(m) for m in ref_models]
    ch = ("latency", "energy")
    ref = RS.stack_cost_tensors(ref_models, ns, channels=ch)
    port = PS.stack_cost_tensors(port_models, ns, channels=ch)
    return ref, port, np.array(ns)


def test_stack_cost_tensors_equal():
    ref, port, _ = channel_stacks()
    assert ref.shape == port.shape == (2, 12, 5, 54, 54)
    assert np.array_equal(ref, port)


MULTI_CASES = {
    "budget": dict(energy_budget=1.5),
    "budget per scenario": dict(energy_budget=list(np.linspace(0.8, 3.0, 12))),
    "weights": dict(channel_weights=(1.0, 0.25)),
    "weights and budget": dict(channel_weights=(1.0, 0.1), energy_budget=2.0),
    "max combine": dict(combine="max", energy_budget=1.5),
    "channel combines": dict(channel_combines=("max", "max"), energy_budget=2.0),
}


@pytest.mark.parametrize("port_backend,dtype,ref_backend", DP_PAIRS, ids=DP_IDS)
@pytest.mark.parametrize("case", sorted(MULTI_CASES))
def test_solve_multi_channel(case, port_backend, dtype, ref_backend):
    ref_C, port_C, ns = channel_stacks()
    kw = MULTI_CASES[case]
    ref = RS.solve_multi_channel(ref_C, backend=ref_backend, n_devices=ns, **kw)
    port = PS.solve_multi_channel(port_C, n_devices=ns,
                                  **port_kw(port_backend, dtype), **kw)
    assert_batched_equal(port, ref, same_backend=False)
    assert ref.feasible.any()


@pytest.mark.parametrize("solver", ["batched_beam", "batched_greedy"])
def test_solve_multi_channel_heuristics(solver):
    ref_C, port_C, ns = channel_stacks()
    ref = RS.solve_multi_channel(ref_C, solver=solver, n_devices=ns, energy_budget=1.5)
    port = PS.solve_multi_channel(port_C, solver=solver, n_devices=ns, energy_budget=1.5)
    assert_batched_equal(port, ref)


def test_solve_multi_channel_degenerate_is_solve_batched():
    ref_C, port_C, ns = channel_stacks()
    one = PS.solve_multi_channel(port_C[:1], channels=("latency",), n_devices=ns,
                                 backend="numpy")
    assert_batched_equal(one, PS.solve_batched(port_C[0], n_devices=ns,
                                               backend="numpy"))
    assert_batched_equal(one, RS.solve_multi_channel(ref_C[:1], channels=("latency",),
                                                     n_devices=ns))


@functools.lru_cache(maxsize=None)
def variant_stacks(V):
    """(reference, port, accuracy proxies, fleet sizes) variant stacks of
    8 MobileNet-V2 cost models over the first ``V`` entries of the ESP32
    variant bank."""
    bank = RP.esp32_variant_bank()[:V]
    ref_models = [RL.SplitCostModel(profile=RP.mobilenet_cost_profile(),
                                    devices=(RP.ESP32,),
                                    link=replace(RP.PROTOCOLS[p], loss_p=lp))
                  for p in ("udp", "ble") for lp in (0.0, 0.1, 0.2, 0.3)]
    ns = [2, 3, 4, 5] * 2
    port_models = [convert.cost_model_from_reference(m) for m in ref_models]
    ref = RS.stack_cost_tensors(ref_models, ns, variants=bank)
    port = PS.stack_cost_tensors(port_models, ns,
                                 variants=[convert.variant_from_reference(v) for v in bank])
    assert np.array_equal(ref, port)
    return ref, port, [v.accuracy_proxy for v in bank], np.array(ns)


@pytest.mark.parametrize("port_backend,dtype,ref_backend", DP_PAIRS, ids=DP_IDS)
@pytest.mark.parametrize("V,floor", [(1, None), (3, None), (3, 0.96)])
def test_solve_variant_bank(V, floor, port_backend, dtype, ref_backend):
    ref_C, port_C, acc, ns = variant_stacks(V)
    kw = dict(n_devices=ns, accuracy_proxy=acc, accuracy_floor=floor)
    ref = RS.solve_variant_bank(ref_C, backend=ref_backend, **kw)
    port = PS.solve_variant_bank(port_C, **port_kw(port_backend, dtype), **kw)
    assert_batched_equal(port, ref, same_backend=False)
    if floor is not None:
        assert set(ref.variant.tolist()) <= {-1, 0, 1}


def test_solve_variant_bank_beam():
    ref_C, port_C, acc, ns = variant_stacks(3)
    kw = dict(solver="batched_beam", n_devices=ns, accuracy_proxy=acc,
              accuracy_floor=0.9, beam_width=4)
    assert_batched_equal(PS.solve_variant_bank(port_C, **kw),
                         RS.solve_variant_bank(ref_C, **kw))


def test_accuracy_floor_and_channel_combine():
    _, port_C, acc, _ = variant_stacks(3)
    masked = PS.apply_accuracy_floor(port_C, acc, 0.96)
    assert np.array_equal(masked, RS.apply_accuracy_floor(port_C, acc, 0.96))
    assert PS.apply_accuracy_floor(port_C, acc, None) is port_C
    ref_C, port_C, _ = channel_stacks()
    assert np.array_equal(PS.combine_channels(port_C, (1.0, 0.0)),
                          RS.combine_channels(ref_C, (1.0, 0.0)))


# ---------------------------------------------------------------------------
# Sweep additions
# ---------------------------------------------------------------------------


MODELS = {"mobilenet_v2": RP.mobilenet_cost_profile(),
          "resnet50": RP.resnet50_cost_profile()}


def heuristic_grid():  # 2 models x 2 mixes x 3 fleets x 2 protocols x 2 x 2 = 96
    fast = RL.DeviceProfile("srv", compute_scale=0.05)
    return RS.ScenarioGrid(
        models=MODELS, links={p: RP.PROTOCOLS[p] for p in ("udp", "esp_now")},
        n_devices=(2, 3, 5), loss_p=(None, 0.2), rate_scale=(1.0, 0.5),
        devices=(RP.ESP32,), device_mixes={"srv_tail": (RP.ESP32,) * 4 + (fast,)})


def compression_grid():  # 2 protocols x 2 fleets x 2 rates x 3 factors x 2 budgets
    links = {p: replace(RP.PROTOCOLS[p], tx_power_w=0.3, rx_power_w=0.2)
             for p in ("udp", "ble")}
    return RS.ScenarioGrid(
        models={"mobilenet_v2": MODELS["mobilenet_v2"]}, links=links,
        n_devices=(2, 4), rate_scale=(1.0, 0.25),
        devices=(replace(RP.ESP32, active_power_w=0.5),),
        compression_factors=(1.0, 2.0, 4.0), energy_budgets=(None, 2.0),
        variant_encoder_s_per_byte=2e-8)


def rows(res):
    return [row_fields(r) for r in res.rows]


def csv_without_walls(res):
    """``to_csv()`` lines without their last column, the wall share."""
    return [ln.rsplit(",", 1)[0] for ln in res.to_csv().splitlines()]


@pytest.mark.parametrize("solver", ["batched_beam", "batched_greedy"])
@pytest.mark.parametrize("grid", [heuristic_grid, compression_grid],
                         ids=["mixes", "compression"])
def test_sweep_heuristics(grid, solver):
    ref = RS.sweep(grid(), solver=solver, beam_width=4)
    port = PS.sweep(convert.grid_from_reference(grid()), solver=solver,
                    beam_width=4)
    assert (port.solver, port.backend) == (solver, "numpy")
    assert rows(port) == rows(ref)
    assert csv_without_walls(port) == csv_without_walls(ref)


def test_sweep_csv_and_pareto():
    ref = RS.sweep(compression_grid())
    port = PS.sweep(convert.grid_from_reference(compression_grid()), backend="numpy")
    assert rows(port) == rows(ref)
    assert csv_without_walls(port) == csv_without_walls(ref)
    for by in (("model", "protocol", "n_devices"), ("protocol",)):
        rp, pp = ref.pareto(by), port.pareto(by)
        assert list(pp) == list(rp)
        for key in rp:
            assert pp[key].by == rp[key].by and pp[key].key == rp[key].key
            assert [row_fields(r) for r in pp[key].rows] == \
                [row_fields(r) for r in rp[key].rows]
            assert pp[key].to_csv() == rp[key].to_csv()
            assert pp[key].n_points == rp[key].n_points
    assert any(f.n_points > 1 for f in port.pareto().values())
    assert [row_fields(r) for r in PS.pareto_frontier(port.rows)] == \
        [row_fields(r) for r in RS.pareto_frontier(ref.rows)]


@pytest.mark.parametrize("solver", ["optimal_dp", "greedy", "beam"])
def test_sweep_scalar_and_parity_report(solver):
    grid = RS.ScenarioGrid(models=MODELS, links={"udp": RP.UDP, "ble": RP.BLE},
                           n_devices=(2, 3, 4), loss_p=(None, 0.2),
                           rate_scale=(1.0, 0.5), devices=(RP.ESP32,))  # 48
    ref = RS.sweep_scalar(grid, solver=solver)
    port = PS.sweep_scalar(convert.grid_from_reference(grid), solver=solver)
    assert port.backend == "scalar" and rows(port) == rows(ref)
    batched = {"optimal_dp": "batched_dp", "greedy": "batched_greedy",
               "beam": "batched_beam"}[solver]
    rb = RS.sweep(grid, solver=batched)
    pb = PS.sweep(convert.grid_from_reference(grid), solver=batched, backend="numpy")
    assert PS.parity_report(pb, port) == RS.parity_report(rb, ref)
    assert PS.parity_report(pb, PS.SweepResult(port.rows[:3], "x", "y", 0.0, 0.0)) == \
        RS.parity_report(rb, RS.SweepResult(ref.rows[:3], "x", "y", 0.0, 0.0))
