"""Adaptive runtime re-planning on the PyTorch / CUDA port — the paper's
future-work section, live.

The twin of ``examples/adaptive_replanning.py`` on ``repro_torch``. The
managers build their surfaces (the fused DP kernel) and run their exact
re-solves (the dense DP kernel) in float64 on the card, or on the
kernels' plain versions with ``--device cpu``; float64 equals the numpy
oracle the reference example defaults to, so every decision-log line
equals the reference example's (the build and observe walls aside).

Simulates a deployment where network conditions drift: the
AdaptiveSplitManager watches observed hop latencies, re-splits the model
when the link degrades, and switches protocols only when the degradation
is deep enough to overcome the alternatives' setup costs (Table IV).

The manager's hot loop is a precomputed DegradationSurface: every
(protocol x packet-time x loss) link condition was solved ONCE with the
batched sweep engine at startup, so each observe() is an O(1) grid
lookup + hysteresis check instead of a Beam-Search re-solve — the
surface also reports the *switch points* where the optimal plan changes.

The second act drives the link BEYOND the surface envelope with
async_rebuild on: observe() keeps serving from the stale surface
(stale-while-revalidate) while a re-centered rebuild runs "in the
background" — here on a deterministic ManualExecutor so the in-flight
window is visible — and a later observe() atomically swaps the rebuilt
surface in, restoring the O(1) path at the new operating point.

Run: PYTHONPATH=src python examples/torch_adaptive_replanning.py [--device cpu]
(the card by default; it raises without one unless ``--device cpu``).
"""

import argparse
import time

import torch

from repro_torch.core.adaptive import AdaptiveSplitManager
from repro_torch.core.async_replan import ManualExecutor
from repro_torch.core.profiles import ESP_NOW, PROTOCOLS, paper_cost_model
from repro_torch.device import resolve_device


def main(device=None):
    dev = resolve_device(device)
    t0 = time.perf_counter()
    mgr = AdaptiveSplitManager(
        cost_model=paper_cost_model("mobilenet_v2", "esp_now"),
        protocols=dict(PROTOCOLS),
        n_devices=2,
        replan_threshold=0.10,
        device=dev, dtype=torch.float64,
    )
    build_s = time.perf_counter() - t0
    surf = mgr.surface
    print(f"degradation surface: {surf.n_nodes} nodes "
          f"({len(surf.protocols)} protocols), "
          f"{len(surf.switch_points())} switch points, "
          f"built in {build_s * 1e3:.0f} ms (one batched sweep pass)")
    for sp in surf.switch_points()[:5]:
        print(f"  switch[{sp.protocol}] {sp.axis}: {sp.lo:.4g} -> {sp.hi:.4g} "
              f"(other axis @ {sp.fixed:g}): plan {sp.plan_lo} -> {sp.plan_hi}")

    d = mgr.current
    print(f"t=0    plan: {d.protocol} chunk={d.chunk_bytes}B splits={d.splits} "
          f"predicted {d.predicted_latency_s:.3f}s ({d.reason})")

    nbytes = 5488  # the paper's block_16_project_BN activation

    def run_phase(label, factor, steps):
        lat = factor * ESP_NOW.transmission_latency_s(nbytes)
        t0 = time.perf_counter()
        for _ in range(steps):
            mgr.observe("esp_now", nbytes, lat)
        us = (time.perf_counter() - t0) / steps * 1e6
        d = mgr.current
        print(f"{label:6s} ESP-NOW at {factor:3.0f}x nominal -> plan: {d.protocol} "
              f"chunk={d.chunk_bytes}B splits={d.splits} "
              f"predicted {d.predicted_latency_s:.3f}s "
              f"[{us:.0f} us/observe]")

    run_phase("t=1", 1, 30)     # healthy: no change
    run_phase("t=2", 50, 60)    # degraded: surface absorbs it in-protocol
    run_phase("t=3", 400, 120)  # collapsed: protocol switch finally pays

    print(f"\nsurface hits: {mgr.surface_hits}  "
          f"exact envelope fallbacks: {mgr.exact_fallbacks}")
    print("decision log:")
    for d in mgr.history:
        print(f"  step {d.step:4d}: {d.protocol:8s} splits={d.splits} "
              f"chunk={d.chunk_bytes}B predicted={d.predicted_latency_s:.3f}s "
              f"({d.reason})")

    # -- act two: drift past the envelope, rebuild without blocking --------
    print("\n--- async stale-while-revalidate (drift beyond the envelope) ---")
    ex = ManualExecutor()
    amgr = AdaptiveSplitManager(
        cost_model=paper_cost_model("mobilenet_v2", "esp_now"),
        protocols=dict(PROTOCOLS), n_devices=2,
        surface_grid={"pt_scale": (1.0, 4.0, 16.0), "loss_p": (0.0, 0.1)},
        async_rebuild=ex,  # deterministic executor: WE run the build
        device=dev, dtype=torch.float64,
    )
    deep = 3000 * ESP_NOW.transmission_latency_s(nbytes)  # 3000x nominal
    for _ in range(120):
        amgr.observe("esp_now", nbytes, deep)
    print(f"in-flight: {amgr.stale_serves} observes served from the STALE "
          f"surface, {amgr.exact_fallbacks} bounded exact fallbacks, "
          f"{ex.pending()} rebuild queued (envelope max was 16x nominal)")
    while ex.pending():  # "background" build completes; next observe swaps
        ex.run_all()
        amgr.observe("esp_now", nbytes, deep)
    h0 = amgr.surface_hits
    for _ in range(30):
        amgr.observe("esp_now", nbytes, deep)
    d = amgr.current
    print(f"adopted {amgr.surface_swaps} rebuilt surface(s) "
          f"(generation {amgr._rebuilder.generation}); O(1) lookups are "
          f"back: {amgr.surface_hits - h0}/30 hits at the new operating "
          f"point -> plan {d.protocol} splits={d.splits}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
