"""Batched LM serving with split-aware latency accounting, on the PyTorch /
CUDA port.

The twin of ``examples/serve_split_llm.py`` on ``repro_torch``. A small
decoder-only LM served through the slot-based continuous-batching
runtime; the paper's planner chooses where to split the model across two
pipeline stages (H100s joined by NVLink, the port's defaults) and the
per-token hop cost is accounted with the Eq. 7 link model — the
LLM-serving analogue of the paper's camera-to-classifier pipeline.

The model is the reference example's 4-layer float32 config with seeded
random weights (``params``: a :class:`repro_torch.models.transformer.
Transformer` to serve instead, as the tests pass the reference's). Its
stage plan prices H100 stages, so it may differ from the reference
example's; the served tokens and the hop accounting do not depend on it.

Run: PYTHONPATH=src python examples/torch_serve_split_llm.py [--device cpu]
(the card by default; it raises without one unless ``--device cpu``).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.planner import plan_pipeline
from repro_torch.core.profiles import ESP_NOW, NVLINK
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.graph import arch_layer_graph
from repro_torch.runtime.server import Request, Server, SplitLatencyMeter

CFG = ModelConfig(
    name="serve-demo", family="dense", n_layers=4, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=512, vocab=512, head_dim=32, dtype="float32",
    remat=False, kv_chunk=64, pad_vocab_to=0,
)


def main(device=None, params=None) -> dict:
    """Prints the plan, the served requests and the hop accounting;
    returns ``{"plan", "results", "hops", "hop_seconds"}``."""
    dev = resolve_device(device)
    if params is None:
        # seeded on the CPU, so the card and the CPU serve the same weights
        params = T.init_params(CFG, torch.Generator().manual_seed(0), device="cpu").to(dev)
    print(f"serving {CFG.name} ({CFG.n_params / 1e6:.1f}M params)")

    # plan the 2-way split of this model (block granularity, NVLink)
    g = arch_layer_graph(CFG, batch=4, seq=256)
    plan = plan_pipeline(g, n_stages=2, chips_per_stage=1, link=NVLINK)
    print(f"planner split: {plan.splits} "
          f"(bottleneck {plan.objective_cost_s * 1e6:.1f} us/stage)")

    # price per-token hops like the paper (one d_model row per decode step)
    meter = SplitLatencyMeter(plan=plan, link=ESP_NOW,
                              bytes_per_token=CFG.d_model * 2)
    server = Server(CFG, params, slots=4, max_seq=128, meter=meter)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(8):
        prompt = rng.integers(0, CFG.vocab, size=rng.integers(4, 12))
        server.submit(Request(rid=rid, prompt=prompt.astype(np.int32),
                              max_new_tokens=12))
    results = server.run_until_drained()
    wall = time.perf_counter() - t0

    total_tokens = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests, {total_tokens} tokens "
          f"in {wall:.2f}s ({total_tokens / wall:.1f} tok/s on {dev.type})")
    for rid in sorted(results)[:3]:
        print(f"  req {rid}: {results[rid][:8]}...")
    print(f"modeled split-hop overhead: {meter.hops} hops, "
          f"{meter.hop_seconds:.3f} s total "
          f"({meter.hop_seconds / max(1, total_tokens) * 1e3:.2f} ms/token on ESP-NOW)")
    return {"plan": plan, "results": dict(results), "hops": meter.hops,
            "hop_seconds": meter.hop_seconds}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
