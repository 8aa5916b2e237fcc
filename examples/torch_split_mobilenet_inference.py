"""Split MobileNet-V2 inference across simulated IoT devices on the
PyTorch / CUDA port: the paper's full experiment, end to end.

The twin of ``examples/split_mobilenet_inference.py`` on ``repro_torch``:
  * every protocol (UDP / TCP / ESP-NOW / BLE),
  * every solver (beam / greedy / first-fit / random / DP optimum),
  * split execution on the card with int8 wire quantization,
  * RTT decomposition matching Table IV.

Run: PYTHONPATH=src python examples/torch_split_mobilenet_inference.py [--device cpu]
(the card by default; it raises without one unless ``--device cpu``).
"""

import argparse

import torch

from repro_torch.core.executor import run_split, run_unsplit
from repro_torch.core.latency import rtt_breakdown
from repro_torch.core.planner import compare_solvers, plan_split
from repro_torch.core.profiles import PROTOCOLS, paper_cost_model
from repro_torch.device import resolve_device
from repro_torch.models.mobilenetv2 import MobileNetV2

N_DEVICES = 4


def main(device=None):
    dev = resolve_device(device)
    print(f"=== planning splits for {N_DEVICES} devices, all protocols ===")
    best = {}
    for proto in PROTOCOLS:
        m = paper_cost_model("mobilenet_v2", proto)
        plan = plan_split(m, N_DEVICES, solver="beam")
        best[proto] = plan
        br = rtt_breakdown(m, plan.splits)
        print(f"{proto:8s} splits={plan.splits} RTT={br.rtt_s:.3f}s "
              f"(setup {br.setup_s * 1e3:.0f}ms, tx {sum(br.transmission_s) * 1e3:.1f}ms)")
    winner = min(best, key=lambda p: best[p].total_latency_s)
    print(f"-> best protocol: {winner} (paper: esp_now)\n")

    print("=== solver comparison on the winner ===")
    m = paper_cost_model("mobilenet_v2", winner)
    plans = compare_solvers(m, N_DEVICES,
                            solvers=("beam", "greedy", "first_fit",
                                     "random_fit", "optimal_dp"))
    for name, plan in plans.items():
        print(f"{name:10s} latency {plan.total_latency_s:.3f}s "
              f"planner {plan.planner_time_s * 1e3:.1f}ms splits={plan.splits}")

    print("\n=== executing the beam split with int8 wire ===")
    model = MobileNetV2(width=0.35, image_size=96)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    x = torch.randn(model.input_shape(4), generator=torch.Generator().manual_seed(7)).to(dev)
    ref = run_unsplit(model, params, x)
    out, trace = run_split(model, params, x, plans["beam"].splits,
                           link=PROTOCOLS[winner], quantize_wire=True)
    top1 = torch.mean((torch.argmax(out["h"], -1) == torch.argmax(ref["h"], -1)).float())
    print(f"top-1 agreement across batch: {float(top1) * 100:.0f}%")
    print(f"hops: {[(h.boundary_layer, h.n_packets) for h in trace.hops]}")
    print(f"modeled tx latency: {trace.total_tx_latency_s * 1e3:.1f} ms")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
