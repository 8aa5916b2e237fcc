"""Quickstart on the PyTorch / CUDA port: plan a split, run it, account
the wire.

The twin of ``examples/quickstart.py`` on ``repro_torch``:
  1. build the MobileNet-V2 cost profile calibrated to the paper's
     ESP32-S3 measurements,
  2. beam-search the optimal split for 3 devices over ESP-NOW,
  3. execute the split model on the card and check it against the
     unsplit forward pass,
  4. price every hop with the Eq. 7 packetized-link model.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the card by default; it raises without one unless ``--device cpu``).
"""

import argparse

import torch

from repro_torch.core.executor import run_split, run_unsplit
from repro_torch.core.planner import plan_split
from repro_torch.core.profiles import ESP_NOW, paper_cost_model
from repro_torch.device import resolve_device
from repro_torch.models.mobilenetv2 import MobileNetV2


def main(device=None):
    dev = resolve_device(device)
    # 1. the paper's experimental configuration as a cost model
    cost_model = paper_cost_model("mobilenet_v2", protocol="esp_now")

    # 2. beam-search split points for 3 devices (Algorithm 1)
    plan = plan_split(cost_model, n_devices=3, solver="beam", beam_width=8)
    print(f"split points: {plan.splits}")
    for seg in plan.segments:
        print(f"  device {seg.device}: layers {seg.first_layer}..{seg.last_layer} "
              f"({seg.layer_names[0]} .. {seg.layer_names[-1]}), "
              f"infer {seg.infer_s * 1e3:.0f} ms, ships {seg.tx_bytes} B")
    print(f"predicted end-to-end latency: {plan.total_latency_s:.3f} s "
          f"(planner took {plan.planner_time_s * 1e3:.1f} ms)")

    # 3. execute the split for real (the reference example's small input)
    model = MobileNetV2(width=0.35, image_size=96)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    x = torch.randn(model.input_shape(1), generator=torch.Generator().manual_seed(1)).to(dev)
    ref = run_unsplit(model, params, x)
    out, trace = run_split(model, params, x, plan.splits, link=ESP_NOW,
                           quantize_wire=True)
    agree = torch.argmax(out["h"]) == torch.argmax(ref["h"])
    print(f"split executes correctly: top-1 agreement = {bool(agree)}")

    # 4. wire accounting per hop
    for hop in trace.hops:
        print(f"  hop after {hop.boundary_layer}: {hop.nbytes} B -> "
              f"{hop.n_packets} packets -> {hop.sim_latency_s * 1e3:.1f} ms on air")
    print(f"total modeled transmission: {trace.total_tx_latency_s * 1e3:.1f} ms")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
