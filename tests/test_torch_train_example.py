"""The training example's twin, ``examples/torch_train_pipeline_lm.py``,
on the CPU at a tiny size (12 steps, vocab 64, 32 tokens a row): the
crash at 60% and the resume from the newest checkpoint, the ``LEARNING``
verdict's rule, and plans that are the port's H100 ``plan_pipeline``
over NVLink and InfiniBand. The token stream is the port's own, so the
losses are not the reference example's (``tests/test_torch_data.py``)."""

import re

from repro_torch.core.planner import plan_pipeline
from repro_torch.core.profiles import INFINIBAND, NVLINK
from repro_torch.models.graph import arch_layer_graph
from torch_parity import load_example, plan_fields


def test_twin_crashes_resumes_and_plans_on_h100_stages(capsys):
    mod = load_example("torch_train_pipeline_lm")
    out = mod.main(steps=12, vocab=64, seq=32, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "model: lm-100m ~50M params (vocab 64)"
    assert out["crash_at"] == 7 and out["resumed_from"] == 5  # ckpt_every max(5, 12 // 6)
    assert "!! injected node failure at step 7" in lines
    assert "restarting from checkpoint step 5" in lines
    hist = out["history"]
    assert [r.step for r in hist] == list(range(5, 12))
    assert "resumed at step 5; finished 12 steps" in lines
    first, last, fell = mod.learning([r.loss for r in hist])
    verdict = "LEARNING" if fell else "no progress?!"
    assert f"loss: {first:.3f} -> {last:.3f} ({verdict})" in lines
    cfg = mod.CFG.__class__(**{**mod.CFG.__dict__, "vocab": 64})
    g = arch_layer_graph(cfg, batch=256, seq=4096)
    for link in (NVLINK, INFINIBAND):
        plan = plan_pipeline(g, n_stages=4, chips_per_stage=4, link=link)
        assert plan_fields(out["plans"][link.name]) == plan_fields(plan)
        assert (f"beam PP plan over {link.name}: splits={plan.splits} "
                f"bottleneck={plan.objective_cost_s * 1e3:.2f} ms/stage") in lines
    assert len([ln for ln in lines if re.match(r"beam PP plan over ", ln)]) == 2


def test_learning_verdict_rule():
    mod = load_example("torch_train_pipeline_lm")
    assert mod.learning([4.0] * 10 + [3.9] * 10)[2]
    assert not mod.learning([4.0] * 10 + [3.96] * 10)[2]
    assert not mod.learning([4.0] * 7)[2]  # fewer than 20 losses: both means overlap
