"""Latency-vs-accuracy Pareto frontiers over the bottleneck-compression
axis, per protocol, for both paper models, on the PyTorch / CUDA port.

The twin of ``examples/pareto_frontier.py`` on ``repro_torch``. The sweep
runs the exact DP in float64 (the fused DP kernel on the card, its plain
version with ``--device cpu``), which equals the numpy oracle the
reference example defaults to, so its frontier tables equal the
reference example's lines. Step 4 holds the frontier's pick and the
solver's plan to the same latency within 1e-9 s, the reference's own
bound: the two may choose different splits at an exact cost tie (BLE,
ESP-NOW and TCP tie within one ulp in float64), and the reference's
split assertion raises there. The twin prints the frontier's pick as
the reference's line would and counts the ties on one more line.

The paper plans "where to split"; bottleneck compression (a learned
encoder at the cut — the COMSPLIT axis) adds "how hard to squeeze the
cut": each compression factor shrinks the radio payload, costs the
sensor extra encoder compute, and gives up a slice of accuracy. The
planner's decision variable becomes (split point, variant), and the
interesting output is no longer one number but a FRONTIER — the
non-dominated latency/accuracy trade-offs an operator can pick from.

This example sweeps MobileNet-V2 and ResNet50 across every protocol
with `ScenarioGrid(compression_factors=...)` (the variant axis folds
into the same batched pass as everything else), emits the per
model × protocol frontiers with `SweepResult.pareto()`, and prints:

  1. each frontier — latency, accuracy proxy, compression, splits —
     with the dominated rows it filtered out,
  2. where compression actually pays: the latency saved at each
     accuracy step-down vs the full-accuracy identity plan,
  3. accuracy-constrained planning: the cheapest plan subject to
     `accuracy_proxy >= floor`, read straight off the frontier,
  4. the same floor answered by the solver itself
     (`plan_split(variants=..., accuracy_floor=...)`) — the two agree
     on the latency, and on the splits wherever the latencies do not tie.

Run: PYTHONPATH=src python examples/torch_pareto_frontier.py [--device cpu]
(the card by default; it raises without one unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.planner import plan_split
from repro_torch.core.profiles import (
    ESP32,
    PAPER_COMPRESSION_FACTORS,
    PROTOCOLS,
    esp32_flops_per_s,
    esp32_variant_bank,
    mobilenet_cost_profile,
    paper_cost_model,
    resnet50_cost_profile,
)
from repro_torch.core.sweep import ScenarioGrid, sweep
from repro_torch.device import resolve_device

N_DEVICES = 3  # mobilenet fits 3 ESP32s; resnet50 needs the N=5 rows
ACCURACY_FLOOR = 0.95


def main(device=None) -> dict:
    """Prints the frontiers and the step-4 check; returns step 4 by
    protocol: the frontier's pick and the solver's plan."""
    dev = resolve_device(device)
    grid = ScenarioGrid(
        models={"mobilenet_v2": mobilenet_cost_profile(),
                "resnet50": resnet50_cost_profile()},
        links=dict(PROTOCOLS),
        n_devices=(N_DEVICES, 5),
        devices=(ESP32,),
        compression_factors=PAPER_COMPRESSION_FACTORS,
        # price the encoder like esp32_variant_bank does (16 flops per
        # raw activation byte at the calibrated ESP32 rate), so the
        # sweep and the scalar plan_split(variants=...) check below see
        # the same bank
        variant_encoder_s_per_byte=16.0 / esp32_flops_per_s(),
    )
    t0 = time.perf_counter()
    result = sweep(grid, solver="batched_dp", device=dev, dtype=torch.float64)
    fronts = result.pareto()
    wall = time.perf_counter() - t0
    print(f"swept {result.n_scenarios} (model, protocol, variant) "
          f"scenarios and extracted {len(fronts)} frontiers "
          f"in {wall * 1e3:.1f} ms")

    for (model, proto, n), front in sorted(fronts.items()):
        group = [r for r in result.rows if r.feasible
                 and r.scenario.model == model
                 and r.scenario.protocol == proto
                 and r.scenario.n_devices == n]
        if not group:
            continue  # e.g. resnet50 does not fit N=3 ESP32 memories
        print(f"\n-- {model} / {proto} (N={n}): "
              f"{front.n_points} of {len(group)} variants on the frontier --")
        print(f"   {'cx':>4s} {'accuracy':>8s} {'latency':>9s}  splits")
        on_front = set(map(id, front.rows))
        for row in sorted(group, key=lambda r: r.total_latency_s):
            mark = "*" if id(row) in on_front else " "
            print(f" {mark} {row.scenario.compression:>4g} "
                  f"{row.accuracy_proxy:>8.3f} "
                  f"{row.total_latency_s:>8.3f}s  {row.splits}")

        # what each accuracy step-down buys vs the identity plan
        ident = next((r for r in front.rows
                      if r.scenario.compression == 1.0), None)
        if ident is not None:
            for row in front.rows:
                if row is ident:
                    continue
                saved = ident.total_latency_s - row.total_latency_s
                print(f"   cx{row.scenario.compression:g} saves "
                      f"{saved:.3f}s ({saved / ident.total_latency_s:.0%}) "
                      f"for {ident.accuracy_proxy - row.accuracy_proxy:.3f} "
                      f"accuracy")

    # accuracy-constrained planning: frontier read vs solver answer
    print(f"\n-- cheapest plan s.t. accuracy >= {ACCURACY_FLOOR} "
          f"(mobilenet_v2, N={N_DEVICES}) --")
    bank = esp32_variant_bank()
    checked, ties = {}, []
    for proto in sorted(PROTOCOLS):
        front = fronts[("mobilenet_v2", proto, N_DEVICES)]
        ok = [r for r in front.rows if r.accuracy_proxy >= ACCURACY_FLOOR]
        if not ok:
            print(f"  {proto:8s} no plan meets the floor")
            continue
        pick = min(ok, key=lambda r: r.total_latency_s)

        plan = plan_split(paper_cost_model("mobilenet_v2", proto),
                          N_DEVICES, solver="optimal_dp",
                          variants=bank, accuracy_floor=ACCURACY_FLOOR)
        # the plans agree on the latency; at an exact tie they may
        # choose different splits (the frontier's pick is printed)
        assert abs(plan.total_latency_s - pick.total_latency_s) < 1e-9, \
            (proto, plan.total_latency_s, pick.total_latency_s)
        if plan.splits != pick.splits:
            ties.append(f"{proto} {pick.splits} vs {plan.splits}")
        checked[proto] = {"pick": pick, "plan": plan}
        print(f"  {proto:8s} cx{pick.scenario.compression:<4g} "
              f"splits={pick.splits} latency {pick.total_latency_s:.3f}s "
              f"accuracy {pick.accuracy_proxy:.3f} "
              f"(solver agrees: variant={plan.variant})")
    print(f"  latency ties within 1e-9 s where the frontier and the solver chose "
          f"different splits: {len(ties)}" + (f" ({'; '.join(ties)})" if ties else ""))
    return checked


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
