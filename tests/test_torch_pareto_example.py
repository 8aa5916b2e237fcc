"""``examples/torch_pareto_frontier.py`` against
``examples/pareto_frontier.py``, on the CPU.

The reference example raises at its step 4 (``AssertionError: ('ble',
(42, 53), (48, 53))``): the frontier's pick and ``plan_split``'s plan are
an exact cost tie (equal to the last ulp in float64), and it asserts
equal splits. The twin holds the two to the reference's second bound,
latencies within 1e-9 s, and counts the ties.

So the twin's lines before step 4 are held to the lines the reference
prints before it raises (the sweep's wall aside), and step 4 by
protocol: the twin's frontier pick equal to the reference sweep's, the
twin's ``plan_split`` equal to the reference's, and equal latencies."""

import re

import pytest

from repro.core.planner import plan_split
from repro.core.profiles import PROTOCOLS, esp32_variant_bank, paper_cost_model
from repro.core.sweep import sweep
from torch_parity import load_example, printed

WALLS = [(r"frontiers in [0-9.]+ ms", "frontiers in <wall> ms")]
STEP4 = "-- cheapest plan s.t. accuracy >= "


def reference_step4(ref) -> dict:
    """The reference example's step 4 without its split assertion: by
    protocol, the frontier's pick and the solver's plan."""
    grid = ref.ScenarioGrid(
        models={"mobilenet_v2": ref.mobilenet_cost_profile(),
                "resnet50": ref.resnet50_cost_profile()},
        links=dict(PROTOCOLS), n_devices=(ref.N_DEVICES, 5), devices=(ref.ESP32,),
        compression_factors=ref.PAPER_COMPRESSION_FACTORS,
        variant_encoder_s_per_byte=16.0 / ref.esp32_flops_per_s())
    fronts = sweep(grid, solver="batched_dp").pareto()
    out = {}
    for proto in sorted(PROTOCOLS):
        ok = [r for r in fronts[("mobilenet_v2", proto, ref.N_DEVICES)].rows
              if r.accuracy_proxy >= ref.ACCURACY_FLOOR]
        out[proto] = {
            "pick": min(ok, key=lambda r: r.total_latency_s),
            "plan": plan_split(paper_cost_model("mobilenet_v2", proto), ref.N_DEVICES,
                               solver="optimal_dp", variants=esp32_variant_bank(),
                               accuracy_floor=ref.ACCURACY_FLOOR)}
    return out


def test_twin_prints_the_reference_frontiers_and_resolves_the_ties(capsys):
    ref = load_example("pareto_frontier")
    capsys.readouterr()
    with pytest.raises(AssertionError, match=r"\('ble', \(42, 53\), \(48, 53\)\)"):
        ref.main()
    want = [re.sub(*WALLS[0], line) for line in capsys.readouterr().out.splitlines()]
    got, checked = printed(capsys, load_example("torch_pareto_frontier").main, "cpu",
                           masks=WALLS)
    # the reference prints step 4's heading, then raises at its first row
    assert want[-1].startswith(STEP4) and len(want) > 80
    assert got[:len(want)] == want

    rows = got[len(want):]
    expect = reference_step4(ref)
    assert sorted(checked) == sorted(expect) == sorted(PROTOCOLS)
    ties = []
    for proto, row in zip(sorted(PROTOCOLS), rows):
        pick, plan = checked[proto]["pick"], checked[proto]["plan"]
        ref_pick, ref_plan = expect[proto]["pick"], expect[proto]["plan"]
        assert (pick.scenario.compression, pick.splits, pick.total_latency_s,
                pick.accuracy_proxy) == (ref_pick.scenario.compression, ref_pick.splits,
                                         ref_pick.total_latency_s, ref_pick.accuracy_proxy)
        assert (plan.splits, plan.variant, plan.total_latency_s) == \
            (ref_plan.splits, ref_plan.variant, ref_plan.total_latency_s)
        assert abs(plan.total_latency_s - pick.total_latency_s) < 1e-9
        assert row == (f"  {proto:8s} cx{ref_pick.scenario.compression:<4g} "
                       f"splits={ref_pick.splits} latency {ref_pick.total_latency_s:.3f}s "
                       f"accuracy {ref_pick.accuracy_proxy:.3f} "
                       f"(solver agrees: variant={ref_plan.variant})")
        if plan.splits != pick.splits:
            ties.append(proto)
    assert ties == ["ble", "esp_now", "tcp"]
    assert rows[len(PROTOCOLS)].startswith(
        "  latency ties within 1e-9 s where the frontier and the solver chose "
        "different splits: 3 (ble (48, 53) vs (42, 53); ")
    assert len(rows) == len(PROTOCOLS) + 1
