"""Fleet sweep on the PyTorch / CUDA port: price every protocol /
fleet-size / link-condition what-if in one vectorized pass, then read off
operating policy.

The twin of ``examples/fleet_sweep.py`` on ``repro_torch``. Its sweeps
run the exact DP in float64 (the fused DP kernel on the card, its plain
version with ``--device cpu``), which equals the numpy oracle the
reference example defaults to, so every line but the wall time and the
rate equals the reference example's.

The paper plans one configuration at a time. A fleet controller needs
the whole decision surface — "which protocol and split should a fleet
of N devices use if the link degrades to X?" — refreshed continuously.
This example sweeps a 256-point grid (4 protocols × 4 fleet sizes ×
4 loss rates × 4 bandwidth scales) for MobileNet-V2 on ESP32-S3 in a
few milliseconds and prints:

  1. the best protocol + split per fleet size under nominal conditions,
  2. how the best plan shifts as the link degrades (the re-planning
     surface the AdaptiveSplitManager walks at runtime),
  3. how heterogeneous device mixes (a fast gateway tail, degraded
     nodes) move the optimal split — priced in the SAME batched pass,
  4. engine throughput vs the scalar per-scenario loop,
  5. shared-channel contention + per-device energy budgets: a second
     grid with `contention_groups=` / `energy_budgets=` axes shows how
     concurrent transmitters and Joule caps move the optimal plan.

Run: PYTHONPATH=src python examples/torch_fleet_sweep.py [--device cpu]
(the card by default; it raises without one unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace

import torch

from repro_torch.core.profiles import ESP32, PROTOCOLS, mobilenet_cost_profile
from repro_torch.core.sweep import ScenarioGrid, sweep
from repro_torch.device import resolve_device


def main(device=None):
    dev = resolve_device(device)
    grid = ScenarioGrid(
        models={"mobilenet_v2": mobilenet_cost_profile()},
        links=dict(PROTOCOLS),
        n_devices=(2, 3, 4, 5),
        loss_p=(None, 0.01, 0.05, 0.10),
        rate_scale=(1.0, 0.5, 0.25, 0.125),
        devices=(ESP32,),
        # heterogeneous what-ifs ride the same batched pass: a fleet
        # whose tail node is a 4x-faster gateway, and one downgraded
        # to half-speed ESP32s (mix=None keeps the homogeneous fleet)
        device_mixes={
            "gateway_tail": (ESP32, ESP32, ESP32, ESP32,
                             replace(ESP32, name="gateway",
                                     compute_scale=0.25,
                                     mem_limit_bytes=None)),
            "slow_nodes": (replace(ESP32, name="esp32_half",
                                   compute_scale=2.0),),
        },
    )
    t0 = time.perf_counter()
    result = sweep(grid, solver="batched_dp", device=dev, dtype=torch.float64)
    wall = time.perf_counter() - t0
    print(f"swept {result.n_scenarios} scenarios in {wall * 1e3:.1f} ms "
          f"({result.scenarios_per_sec:,.0f} scenarios/s)")

    print("\n-- best protocol per fleet size (nominal link, homogeneous) --")
    for n in grid.n_devices:
        rows = [r for r in result.rows
                if r.feasible and r.scenario.n_devices == n
                and r.scenario.mix is None
                and r.scenario.loss_p is None and r.scenario.rate_scale == 1.0]
        if not rows:
            print(f"  N={n}: no feasible plan")
            continue
        best = min(rows, key=lambda r: r.total_latency_s)
        print(f"  N={n}: {best.scenario.protocol:8s} splits={best.splits} "
              f"latency {best.total_latency_s:.3f}s "
              f"(device {best.device_s:.3f}s + tx {best.transmission_s:.3f}s)")

    print("\n-- degradation surface (N=3): best plan vs link condition --")
    print(f"  {'rate×':>6s} {'loss':>5s}  protocol  splits -> latency")
    for rs in grid.rate_scale:
        for lp in grid.loss_p:
            rows = [r for r in result.rows
                    if r.feasible and r.scenario.n_devices == 3
                    and r.scenario.mix is None
                    and r.scenario.loss_p == lp and r.scenario.rate_scale == rs]
            if not rows:
                continue
            best = min(rows, key=lambda r: r.total_latency_s)
            loss = "base" if lp is None else f"{lp:.2f}"
            print(f"  {rs:>6g} {loss:>5s}  {best.scenario.protocol:8s} "
                  f"{str(best.splits):14s} -> {best.total_latency_s:.3f}s")

    # protocol switch points: where does the argmin protocol change?
    switches = set()
    for rs in grid.rate_scale:
        prev = None
        for lp in (p for p in grid.loss_p):
            rows = [r for r in result.rows
                    if r.feasible and r.scenario.n_devices == 3
                    and r.scenario.mix is None
                    and r.scenario.loss_p == lp and r.scenario.rate_scale == rs]
            if not rows:
                continue
            proto = min(rows, key=lambda r: r.total_latency_s).scenario.protocol
            if prev is not None and proto != prev:
                switches.add((rs, lp, prev, proto))
            prev = proto
    if switches:
        print("\nprotocol switch points (rate×, loss): " + ", ".join(
            f"{rs}x/{lp}: {a}->{b}" for rs, lp, a, b in sorted(
                switches, key=str)))
    else:
        print("\nno protocol switches across this grid "
              "(one protocol dominates everywhere)")

    print("\n-- heterogeneous fleets (N=5, nominal link) --")
    for mx in grid.mix_names:
        rows = [r for r in result.rows
                if r.feasible and r.scenario.n_devices == 5
                and r.scenario.mix == mx
                and r.scenario.loss_p is None and r.scenario.rate_scale == 1.0]
        if not rows:
            print(f"  {mx or 'homogeneous'}: no feasible plan")
            continue
        best = min(rows, key=lambda r: r.total_latency_s)
        print(f"  {mx or 'homogeneous':13s} {best.scenario.protocol:8s} "
              f"splits={best.splits} latency {best.total_latency_s:.3f}s")

    contention_and_budget(dev)


def contention_and_budget(device):
    """Multi-channel what-ifs: shared-channel contention scales the
    effective link rate, per-device Joule budgets mask over-budget
    segments before the solve — both just extra grid axes priced in
    the same batched pass."""
    import numpy as np

    # energy is opt-in: give the radio and the MCU non-zero powers
    dev = replace(ESP32, active_power_w=0.5)
    links = {name: replace(lk, tx_power_w=0.24, rx_power_w=0.12)
             for name, lk in PROTOCOLS.items()}
    # pick a Joule cap that actually binds: the 60th percentile of the
    # per-segment energy tensor under the nominal protocol
    probe = ScenarioGrid(models={"mobilenet_v2": mobilenet_cost_profile()},
                         links={"esp_now": links["esp_now"]},
                         n_devices=(3,), devices=(dev,))
    E = probe.cost_model(next(iter(probe.scenarios()))).energy_cost_tensor(3)
    cap = float(np.percentile(E[np.isfinite(E)], 60.0))

    grid = ScenarioGrid(
        models={"mobilenet_v2": mobilenet_cost_profile()},
        links=links,
        n_devices=(3,),
        devices=(dev,),
        contention_groups=(1, 2, 4),   # concurrent transmitters sharing
        mac_efficiency=0.9,            # ...the channel at 90% MAC efficiency
        energy_budgets=(None, cap),    # uncapped vs binding Joule budget
    )
    result = sweep(grid, solver="batched_dp", device=device, dtype=torch.float64)

    print(f"\n-- contention × energy budget (N=3, {grid.size} scenarios, "
          f"cap {cap:.2f} J/device) --")
    print(f"  {'tx':>3s} {'budget':>7s}  protocol  splits -> latency"
          f"   (energy/device)")
    for cg in grid.contention_groups:
        for eb in grid.energy_budgets:
            rows = [r for r in result.rows
                    if r.feasible and r.scenario.contention == cg
                    and r.scenario.energy_budget == eb]
            if not rows:
                print(f"  {cg:>3d} {'cap' if eb else 'none':>7s}  infeasible")
                continue
            best = min(rows, key=lambda r: r.total_latency_s)
            m = grid.cost_model(best.scenario)
            efn = m.energy_segment_fn()
            L = m.profile.num_layers
            bounds = (0,) + tuple(best.splits) + (L,)
            e_max = max(efn(bounds[k] + 1, bounds[k + 1], k + 1)
                        for k in range(3))
            print(f"  {cg:>3d} {'cap' if eb else 'none':>7s}  "
                  f"{best.scenario.protocol:8s} {str(best.splits):10s} "
                  f"-> {best.total_latency_s:.3f}s   (max {e_max:.2f} J)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
