"""The ``torch.distributed`` forms of the sharded DP and of the pipeline,
over 4 ``gloo`` ranks on the CPU.

The only test file that starts processes: one module-scoped
``torch.multiprocessing.spawn`` of 4 ranks (``tests/torch_dist_worker.py``)
runs every case and pickles its results; the tests here compare them with
the same calls made in this process, which initialises no process group.
Each rank takes one thread, the rendezvous is a ``file://`` URL in a
temporary directory, and the join has a deadline that fails the tests
with the ranks' stderr.

* The sharded DP with a coordinator in the spec (the first call brings
  the group up) and with ``coordinator=None`` (the group the caller
  holds), at 7 and 65 scenarios (padded to 8 and 68), frozen rows,
  all-k, 3 shards on 4 ranks: every rank's result equals
  ``backend="torch"`` and 4 simulated shards in one process, node for node.
* The pipeline with rank = stage (uniform and ``(3, 5, 7)`` splits, and
  ``reduced()`` deepseek-7b through its blocks): every rank's output is
  bit-equal to the pipeline over ``["cpu"] * 4`` in one process."""

import pickle
import time

import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker as W
from repro_torch.core import shard as SH
from repro_torch.core import sweep as PS
from repro_torch.parallel import pipeline as PP
from torch_parity import one_torch_thread  # noqa: F401

JOIN_DEADLINE_S = 120


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results, in rank order."""
    out = tmp_path_factory.mktemp("ranks")
    url = f"file://{out / 'rendezvous'}"
    ctx = mp.spawn(W.run_rank, args=(W.WORLD, url, str(out)), nprocs=W.WORLD, join=False)
    deadline = time.monotonic() + JOIN_DEADLINE_S
    failure = None
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                failure = f"the ranks did not finish within {JOIN_DEADLINE_S} s"
                break
    except Exception as e:  # a rank raised or died: fail with what it said
        failure = f"{type(e).__name__}: {e}"
    if failure is not None:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        errs = "\n".join(f"--- rank {r} stderr:\n"
                         + (out / f"rank{r}.err").read_text()[-3000:]
                         for r in range(W.WORLD) if (out / f"rank{r}.err").exists())
        pytest.fail(f"{failure}\n{errs}")
    results = []
    for r in range(W.WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def assert_nodes_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_nodes_equal(g, w)
        elif k == "backend" or w is None:
            assert g == w
        else:
            assert g.dtype == w.dtype and g.shape == w.shape and (g == w).all(), k


def without_backend(nodes: dict) -> dict:
    if "backend" in nodes:
        return {k: v for k, v in nodes.items() if k != "backend"}
    return {n: without_backend(v) for n, v in nodes.items()}


def in_process(label):
    _, S, N, L, combine, n_shards, all_k = next(c for c in W.DP_CASES if c[0] == label)
    C, ns = W.dp_inputs(S, N, L)
    kw = dict(return_all_k=True) if all_k else dict(n_devices=ns)
    torch_route = W.nodes(PS.batched_optimal_dp(C, combine, "torch", device="cpu", **kw))
    shards = W.nodes(SH.sharded_optimal_dp(C, combine, n_shards=n_shards or W.WORLD,
                                           device="cpu", **kw))
    return torch_route, shards


@pytest.mark.parametrize("label", [c[0] for c in W.DP_CASES])
@pytest.mark.parametrize("form", ["coordinator", "no coordinator"])
def test_sharded_dp_over_ranks(ranks, form, label):
    torch_route, shards = in_process(label)
    for res in ranks:
        got = res[form][label]
        assert_nodes_equal(got, shards)
        assert_nodes_equal(without_backend(got), without_backend(torch_route))


def test_batched_optimal_dp_over_ranks(ranks):
    C, ns = W.dp_inputs(13, 3, 7)
    want = W.nodes(PS.batched_optimal_dp(C, "sum", "sharded", n_devices=ns, device="cpu"))
    for res in ranks:
        assert_nodes_equal(res["batched_optimal_dp"], want)


@pytest.mark.parametrize("name", sorted(W.TOY_SPLITS))
def test_pipeline_over_ranks(ranks, name):
    params, x = W.toy_inputs()
    want = PP.run_pipeline(W.Plan(W.TOY_SPLITS[name]), W.toy_block, params, W.TOY["L"], x,
                           devices=["cpu"] * W.WORLD)
    for res in ranks:
        assert torch.equal(res["pipeline"][name], want)


def test_deepseek_pipeline_over_ranks(ranks):
    stacked, apply, x = W.deepseek_inputs()
    want = PP.run_pipeline(W.Plan(W.TOY_SPLITS["uneven"]), apply, stacked, 8, x,
                           devices=["cpu"] * W.WORLD)
    for res in ranks:
        assert torch.equal(res["pipeline"]["deepseek-7b"], want)
