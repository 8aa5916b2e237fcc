"""End-to-end training run on the PyTorch / CUDA port: a ~100M-param
LM trained for a few hundred steps with the fault-tolerant runtime, on a
learnable synthetic stream.

The twin of ``examples/train_pipeline_lm.py`` on ``repro_torch``: config
-> data pipeline -> microbatched train step -> checkpointing (one
simulated crash and an exact resume) -> pipeline planning of the same
model over H100 stages (four cards a stage, NVLink within a host and
InfiniBand across hosts, the port's stage hardware in place of the
reference's TPU slices). The token stream is the port's own
(``repro_torch.data.pipeline``: a seeded ``torch.Generator``, not the
reference's threefry draws), so the losses are not the reference
example's.

Run: PYTHONPATH=src python examples/torch_train_pipeline_lm.py [--steps 300] [--device cpu]
(the card by default; it raises without one unless ``--device cpu``).
"""

import argparse
import dataclasses
import tempfile

import numpy as np

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core.planner import plan_pipeline
from repro_torch.core.profiles import INFINIBAND, NVLINK
from repro_torch.data.pipeline import MarkovLMData
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.graph import arch_layer_graph
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig

# ~100M params: 12L x d512 (embeddings dominate at vocab 8192)
CFG = ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=512, n_heads=8,
    n_kv_heads=8, d_ff=2048, vocab=8192, head_dim=64, dtype="float32",
    remat=False, kv_chunk=128, q_chunk=128, pad_vocab_to=0,
)


class Crash(RuntimeError):
    pass


def learning(losses) -> tuple[float, float, bool]:
    """(mean of the first 10 losses, of the last 10, whether the loss fell
    by more than 0.05): the example's verdict."""
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    return first, last, last < first - 0.05


def main(steps: int = 300, batch: int = 8, seq: int = 128, vocab: int = CFG.vocab,
         device=None) -> dict:
    """Prints what the reference example prints; returns ``{"history"
    (the resumed run's records), "crash_at", "resumed_from", "plans"}``."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(CFG, vocab=vocab)
    print(f"model: {cfg.name} ~{cfg.n_params / 1e6:.0f}M params (vocab {cfg.vocab})")
    data = MarkovLMData(cfg, global_batch=batch, seq_len=seq, branch=4)

    opt_cfg = AdamWConfig(lr=1e-3)
    with tempfile.TemporaryDirectory() as tmp:
        store = CheckpointStore(tmp, keep=2)
        loop = TrainLoopConfig(total_steps=steps, ckpt_every=max(5, steps // 6), log_every=25)

        # phase 1: train, then simulate a node failure at 60% progress
        crash_at = int(steps * 0.6)

        def failure(step):
            if step == crash_at:
                print(f"!! injected node failure at step {step}")
                raise Crash()

        try:
            Trainer(cfg, data, store, loop, opt_cfg=opt_cfg, failure_hook=failure,
                    device=dev).run()
        except Crash:
            pass
        resumed_from = store.latest_step()
        print(f"restarting from checkpoint step {resumed_from}")

        # phase 2: resume to completion; the loop restores and continues
        hist = Trainer(cfg, data, store, loop, opt_cfg=opt_cfg, device=dev).run()
        print(f"resumed at step {hist[0].step}; finished {hist[-1].step + 1} steps")
        first, last, fell = learning([r.loss for r in hist])
        print(f"loss: {first:.3f} -> {last:.3f} ({'LEARNING' if fell else 'no progress?!'})")
        stragglers = [r.step for r in hist if r.straggler]
        if stragglers:
            print(f"straggler steps flagged: {stragglers[:5]}...")

    # phase 3: how would the paper's planner pipeline THIS model on H100s?
    g = arch_layer_graph(cfg, batch=256, seq=4096)
    plans = {}
    for link in (NVLINK, INFINIBAND):
        plan = plans[link.name] = plan_pipeline(g, n_stages=4, chips_per_stage=4, link=link)
        print(f"beam PP plan over {link.name}: splits={plan.splits} "
              f"bottleneck={plan.objective_cost_s * 1e3:.2f} ms/stage")
    return {"history": hist, "crash_at": crash_at, "resumed_from": resumed_from,
            "plans": plans}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=CFG.vocab,
                    help="shrink for quick CPU demos (learning needs "
                         "tokens ~ vocab x branch x 10)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args()
    main(a.steps, a.batch, a.seq, a.vocab, a.device)
