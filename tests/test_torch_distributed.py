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
  bit-equal to the pipeline over ``["cpu"] * 4`` in one process; under
  autograd the group form raises ``RuntimeError`` on every rank."""

import math
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


def test_the_group_form_refuses_autograd(ranks):
    """Over the ranks, ``batch_isend_irecv`` has no backward: stage
    parameters or an input that require grad raise ``RuntimeError`` on
    every rank; under ``torch.no_grad()`` the same call runs and equals
    the one-process form."""
    params, x = W.toy_inputs()
    want = PP.run_pipeline(W.Plan(W.TOY_SPLITS["uniform"]), W.toy_block, params, W.TOY["L"], x,
                           devices=["cpu"] * W.WORLD)
    for res in ranks:
        got = res["pipeline refuses autograd"]
        for case in ("params", "input"):
            assert got[case] is not None and "has no backward" in got[case], case
        assert torch.equal(got["no_grad"], want)


def test_deepseek_pipeline_over_ranks(ranks):
    stacked, apply, x = W.deepseek_inputs()
    want = PP.run_pipeline(W.Plan(W.TOY_SPLITS["uneven"]), apply, stacked, 8, x,
                           devices=["cpu"] * W.WORLD)
    for res in ranks:
        assert torch.equal(res["pipeline"]["deepseek-7b"], want)


# --------------------------------------------------------------------------
# the cells on a 2 x 2 ("data", "model") mesh of the 4 ranks
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cell_reference():
    """The unsharded model of the ranks' cells, with their inputs."""
    cfg, model = W.cell_model()
    return cfg, model, W.cell_inputs(cfg)


def dp_rows(batch: dict, i: int, n: int = 2) -> dict:
    """Rows ``i`` of ``n`` equal DP shards of every batched entry (dim 0,
    or dim 1 of a microbatched one)."""
    out = {}
    for k, v in batch.items():
        if v.dim() == 0:
            out[k] = v
        else:
            d = 1 if v.dim() == 3 else 0
            out[k] = v.chunk(n, dim=d)[i]
    return out


def shard_of(full: torch.Tensor, spec: tuple, coordinate: tuple) -> torch.Tensor:
    """The block of ``full`` that the mesh coordinate holds under ``spec``
    (even splits; a tuple entry splits major axis first)."""
    axes = list(W.CELL_MESH)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else entry
        index, n = 0, 1
        for a in names:
            index = index * W.CELL_MESH[a] + coordinate[axes.index(a)]
            n *= W.CELL_MESH[a]
        full = full.chunk(n, dim=d)[index]
    return full


@pytest.mark.parametrize("name", ["prefill 1", "prefill 2"])
def test_prefill_cell_on_a_mesh_equals_the_unsharded_model(ranks, cell_reference, name):
    """Placements applied: every rank's gathered logits equal the unsharded
    prefill step's, bit for bit (batch 2 is DP-sharded: each DP shard's
    rows against the step on those rows)."""
    from repro_torch.launch.steps import make_prefill_step

    cfg, model, inputs = cell_reference
    step = make_prefill_step(cfg)
    batch = inputs[name]
    n = batch["tokens"].shape[0]
    want = torch.cat([step(model, dp_rows(batch, i, n)) for i in range(n)])
    for res in ranks:
        assert torch.equal(res["cells"][name], want)


def test_decode_cell_on_a_mesh_equals_the_unsharded_model(ranks, cell_reference):
    """The decode cell's logits and the cache row it wrote equal the
    unsharded decode step's on each DP shard of the batch and cache."""
    from repro_torch.launch.steps import make_decode_step

    cfg, model, inputs = cell_reference
    inp, cache = inputs["decode"]
    step = make_decode_step(cfg)
    logits, rows = [], []
    for i in range(2):
        c = {k: v.chunk(2, dim=1)[i].clone() for k, v in cache.items()}
        out, c = step(model, dp_rows(inp, i), c)
        logits.append(out)
        rows.append({k: v[:, :, W.CELL_INDEX] for k, v in c.items()})
    for res in ranks:
        got, got_rows = res["cells"]["decode"]
        assert torch.equal(got, torch.cat(logits))
        for k in cache:
            assert torch.equal(got_rows[k], torch.cat([r[k] for r in rows], dim=1)), k


def composition(cfg, model, batch) -> tuple[dict, list, list]:
    """The cell's accumulator summed in one process: microbatch by
    microbatch, in order, (DP shard 0's gradient + DP shard 1's) in
    float32. Returns it, each microbatch's loss (the DP shards' mean)
    and every (microbatch, DP shard) gradient."""
    from repro_torch.launch.steps import loss_and_grads

    accum, losses, terms = None, [], []
    for i in range(2):
        mb = {k: v[i] for k, v in batch.items()}
        parts = [loss_and_grads(cfg, model, dp_rows(mb, r)) for r in range(2)]
        step_sum = {k: parts[0][1][k].float() + parts[1][1][k].float() for k in parts[0][1]}
        accum = step_sum if accum is None else {k: accum[k] + g for k, g in step_sum.items()}
        losses.append((parts[0][0] + parts[1][0]) / 2)
        terms += [grads for _, grads in parts]
    return accum, losses, terms


def gamma(k: int, dtype) -> float:
    """Higham's gamma_k = k u / (1 - k u) for ``dtype``'s unit roundoff u."""
    ku = k * torch.finfo(dtype).eps / 2
    return ku / (1 - ku)


def test_zero_accumulator_shards_equal_the_single_process_composition(ranks, cell_reference):
    """Each rank's accumulator shard is bit-equal to its block of an
    accumulator summed in one process, microbatch by microbatch in order,
    as (DP shard 0's gradient + DP shard 1's gradient) in float32: a
    two-term sum does not depend on its order. The moments' ZeRO rule
    shards the large leaves over "data" too; the loss is the mean over
    microbatches and DP shards."""
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import params_sharding

    cfg, model, inputs = cell_reference
    accum, losses, _ = composition(cfg, model, inputs["train"])
    specs = params_sharding(adamw_init(dict(model.named_parameters())), W.CELL_MESH,
                            fsdp=True)["mu"]
    assert any("data" in s.spec for s in specs.values())  # ZeRO shards some leaves over DP
    for res in ranks:
        cells = res["cells"]
        for k, got in cells["accum"].items():
            want = shard_of(accum[k], specs[k].spec, cells["coordinate"])
            assert got.shape == want.shape and torch.equal(got, want), k
        assert abs(float(cells["accum loss"]) - float(sum(losses) / 2)) <= 1e-6


def test_train_cell_leaves_the_ranks_equal(ranks, cell_reference):
    """After one train step with ``accum_shardings``, every rank holds the
    same parameters (each gathered from the updated shards), different
    from the initial ones and finite, and the same loss and norm."""
    _, model, _ = cell_reference
    first = ranks[0]["cells"]["train"]
    init = dict(model.named_parameters())
    for k, p in first["params"].items():
        assert torch.isfinite(p).all() and not torch.equal(p, init[k]), k
    for res in ranks[1:]:
        got = res["cells"]["train"]
        for k, p in got["params"].items():
            assert torch.equal(p, first["params"][k]), k
        for m in ("loss", "grad_norm", "lr"):
            assert torch.equal(got["metrics"][m], first["metrics"][m]), m


def norm_bound(grads: dict, terms_per_leaf: int) -> tuple[float, float]:
    """(the norm of ``grads`` (float32 values) taken exactly, in float64,
    and the most that a float32 norm computed as ``global_norm`` computes
    it may differ from it). A leaf's float32 sum of squares adds its
    numel rounded squares in any order, then up to ``terms_per_leaf``
    more terms (the sums over shards and over leaves): within gamma_m x
    its value, m = numel + 1 + terms_per_leaf. With E the sum of those
    bounds, the square root moves by at most E / G and rounds once; the
    float64 sum adds its own gamma_n."""
    sums = {k: float(torch.sum(torch.square(g.double()))) for k, g in grads.items()}
    exact_sq = sum(sums.values())
    exact = math.sqrt(exact_sq)
    n = sum(g.numel() for g in grads.values())
    err = sum(gamma(grads[k].numel() + 1 + terms_per_leaf, torch.float32) * v
              for k, v in sums.items()) + gamma(n, torch.float64) * exact_sq
    return exact, err / exact + gamma(1, torch.float32) * (exact + err / exact)


def clip_scale(norm: torch.Tensor, clip: float) -> float:
    """``adamw_update``'s clip scale for ``norm``."""
    return float(torch.clamp_max(torch.full_like(norm, clip) / torch.clamp_min(norm, 1e-9), 1.0))


def test_train_cell_values_equal_the_unsharded_step(ranks, cell_reference):
    """The values of the 2 x 2 train step (2 microbatches, DP 2), each
    gathered whole on rank 0 (the ranks agree: the test above):

    (a) the parameters, both moments and the step counter are bit-equal
        to the unsharded ``adamw_update`` (the update ``make_train_step``
        applies) on the one-process composition's gradient, accumulator /
        (N x DP) = / 4, clipped by the cell's own norm;
    (b) that norm is within :func:`norm_bound` of the composition's norm:
        each leaf's shard sums, the sum over the 4 ranks and over the
        leaves are the only sums;
    (c) the unsharded ``make_train_step`` on the same four rows, as four
        microbatches of one DP shard each in the cell's order, sums the
        same K = 4 gradients g_k in another order: |g - g'| <= delta =
        2 (K - 1) u sum_k |g_k| / K. Its norm is within the same bound
        plus |delta|, and its first moment (1 - b1) fl(g' s') within
        (1 - b1) (s delta + |s - s'| |g'| + gamma_2 (s |g| + s' |g'|))
        of the cell's, s and s' the clip scales of the two norms. Its
        loss, a mean of the same four losses, is within the 4-term sum's
        bound."""
    from repro_torch.core.quantization import true_divide
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    cfg, model, inputs = cell_reference
    got = ranks[0]["cells"]["train"]
    accum, losses, terms = composition(cfg, model, inputs["train"])
    grads = {k: true_divide(a, 4.0) for k, a in accum.items()}
    opt_cfg = AdamWConfig()
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    _, state, metrics = adamw_update(grads, adamw_init(params), params, opt_cfg,
                                     grad_norm=got["metrics"]["grad_norm"])
    for k in params:  # (a)
        assert torch.equal(got["params"][k], params[k]), k
        assert torch.equal(got["mu"][k], state["mu"][k]), k
        assert torch.equal(got["nu"][k], state["nu"][k]), k
    assert torch.equal(got["step"], state["step"])
    assert torch.equal(got["metrics"]["lr"], metrics["lr"])

    exact, bound = norm_bound(grads, 4 + len(grads))  # (b)
    norm = got["metrics"]["grad_norm"]
    assert abs(float(norm) - exact) <= bound, (float(norm), exact, bound)

    batch = {k: torch.stack([dp_rows({k: v[i]}, r)[k] for i in range(2) for r in range(2)])
             for k, v in inputs["train"].items()}  # (c)
    _, fresh = W.cell_model()
    opt = adamw_init(dict(fresh.named_parameters()))
    _, opt, plain = make_train_step(cfg, opt_cfg, n_microbatches=4)(fresh, opt, batch)
    K, u = 4, torch.finfo(torch.float32).eps / 2
    delta = {k: 2 * (K - 1) * u * sum(t[k].float().abs() for t in terms) / K for k in grads}
    delta_norm = math.sqrt(sum(float(torch.sum(torch.square(d.double()))) for d in delta.values()))
    assert abs(float(plain["grad_norm"]) - exact) <= bound + delta_norm
    s, s_plain = (clip_scale(x, opt_cfg.grad_clip_norm) for x in (norm, plain["grad_norm"]))
    c = (1 - opt_cfg.b1) * (1 + u)
    for k, g in grads.items():
        g_plain = opt["mu"][k].abs() / (1 - opt_cfg.b1) / s_plain
        limit = c * (s * delta[k] + abs(s - s_plain) * g_plain
                     + gamma(2, torch.float32) * (s * g.abs() + s_plain * g_plain)) * (1 + 4 * u)
        gap = (got["mu"][k] - opt["mu"][k]).abs()
        assert bool((gap <= limit).all()), (k, float(gap.max()))
    assert abs(float(plain["loss"]) - float(got["metrics"]["loss"])) \
        <= 2 * gamma(K, torch.float32) * sum(abs(float(x)) for x in losses)
