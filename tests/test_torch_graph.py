"""The port's LM layer graphs against the reference's, node for node.

``arch_layer_graph`` for every config at its full published size (the
graphs are shape arithmetic: nothing is allocated), prefill and decode
shapes; ``transformer_layer_graph`` with and without experts, gated or
not, with a tied head and a decode ``kv_len``; ``ssm_layer_graph``. The
arithmetic is copied in the reference's operation order, so every
node's ``flops``, ``param_count``, ``out_elems`` and ``work_elems`` must
equal the reference's with ``==``."""

import dataclasses

import pytest

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models import graph as RG
from repro_torch.configs import get_config
from repro_torch.models import graph as PG


def graph_fields(g) -> tuple:
    return g.name, g.input_elems, [dataclasses.asdict(n) for n in g.nodes]


# (batch, seq, kv_len): prefill at the planner's sizes, decode steps
# against a long cache, one token
SHAPES = [(8, 1024, None), (4, 512, None), (4, 1, 4096), (1, 1, None)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "b{}-s{}-kv{}".format(*s))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_layer_graph_equals_the_reference(arch, shape):
    batch, seq, kv_len = shape
    want = RG.arch_layer_graph(ref_get_config(arch), batch, seq, kv_len=kv_len)
    got = PG.arch_layer_graph(get_config(arch), batch, seq, kv_len=kv_len)
    assert graph_fields(got) == graph_fields(want)
    assert got.num_layers == get_config(arch).n_layers + 2
    assert got.total_flops == want.total_flops and got.total_params == want.total_params


TRANSFORMER_CASES = {
    "dense": dict(),
    "moe": dict(n_experts=8, top_k=2),
    "plain-mlp-tied": dict(gated_mlp=False, tie_embeddings=True),
    "decode-gqa": dict(seq=1, kv_len=2048, n_kv_heads=2),
    "head-dim": dict(head_dim=96),
}


@pytest.mark.parametrize("case", sorted(TRANSFORMER_CASES))
def test_transformer_layer_graph_equals_the_reference(case):
    kw = dict(name="lm", n_layers=6, d_model=1024, n_heads=16, n_kv_heads=16,
              d_ff=4096, vocab=32000, batch=4, seq=256)
    kw.update(TRANSFORMER_CASES[case])
    assert graph_fields(PG.transformer_layer_graph(**kw)) == \
        graph_fields(RG.transformer_layer_graph(**kw))


@pytest.mark.parametrize("kw", [dict(), dict(expand=3, conv_dim=2), dict(batch=1, seq=1)],
                         ids=["default", "expand3-conv2", "one-token"])
def test_ssm_layer_graph_equals_the_reference(kw):
    args = dict(name="ssm", n_layers=12, d_model=2048, d_state=64, vocab=50280,
                batch=8, seq=1024)
    args.update(kw)
    assert graph_fields(PG.ssm_layer_graph(**args)) == graph_fields(RG.ssm_layer_graph(**args))
