"""``examples/torch_serve_split_llm.py`` against
``examples/serve_split_llm.py``, on the CPU.

The twin serves the reference example's 4-layer float32 config on the
reference's ``init_params(PRNGKey(0))`` weights, carried across with
``convert.lm_params_from_reference``; the reference example serves
through ``SyncedRefServer`` (its ``Server`` can read a host buffer after
it was rewritten: ``tests/test_torch_server.py``). Every request's tokens,
the hop count and the modeled hop seconds must be equal, and so must
every printed line but the plan's, which prices H100 stages on NVLink
(the reference's prices its TPU stages) and is held to the port's own
``plan_pipeline``; walls and rates aside."""

import jax
import numpy as np

from repro_torch import convert
from repro_torch.core.planner import plan_pipeline
from repro_torch.core.profiles import NVLINK
from repro_torch.models import transformer as PT
from repro_torch.models.graph import arch_layer_graph
from torch_parity import load_example, plan_fields, printed, synced_ref_server

WALLS = [(r"in [0-9.]+s \([0-9.]+ tok/s on \w+\)", "in <wall>s (<rate> tok/s)")]


def test_twin_serves_the_reference_examples_tokens(capsys, monkeypatch):
    ref = load_example("serve_split_llm")
    served = []

    class Recording(synced_ref_server()):
        def run_until_drained(self, *args, **kwargs):
            served.append((super().run_until_drained(*args, **kwargs), self.meter))
            return served[-1][0]

    monkeypatch.setattr(ref, "Server", Recording)
    want, _ = printed(capsys, ref.main, masks=WALLS)
    (ref_results, ref_meter), = served

    twin = load_example("torch_serve_split_llm")
    params = PT.Transformer(twin.CFG, device="cpu")
    ref_params = ref.T.init_params(jax.random.PRNGKey(0), ref.CFG)
    params.load_state_dict(convert.lm_params_from_reference(
        twin.CFG, jax.tree.map(np.asarray, ref_params)))
    got, out = printed(capsys, twin.main, "cpu", params, masks=WALLS)

    plan = plan_pipeline(arch_layer_graph(twin.CFG, batch=4, seq=256), 2, link=NVLINK)
    assert plan_fields(out["plan"]) == plan_fields(plan)
    assert got[1] == (f"planner split: {plan.splits} "
                      f"(bottleneck {plan.objective_cost_s * 1e6:.1f} us/stage)")
    assert got[:1] + got[2:] == want[:1] + want[2:] and len(got) == 7
    assert out["results"] == {rid: [int(t) for t in toks] for rid, toks in ref_results.items()}
    assert sum(map(len, out["results"].values())) == 96
    assert (out["hops"], out["hop_seconds"]) == (ref_meter.hops, ref_meter.hop_seconds)
