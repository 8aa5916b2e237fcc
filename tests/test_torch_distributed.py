"""The ``torch.distributed`` forms of the sharded DP and of the pipeline,
over 4 ``gloo`` ranks on the CPU.

One ``torch.multiprocessing.spawn`` of 4 ranks (``tests/torch_dist_worker.py``)
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
  autograd the group form raises ``RuntimeError`` on every rank.
* The cells on two ("data", "model") meshes of the 4 ranks: on 4 x 1 the
  tensor-parallel plan is the identity and every cell is bit-equal to the
  step without a mesh; on 2 x 2 the heads, FFN hidden and vocab are split
  over "model" and the float32 sums they reorder move the results within
  :func:`reordered_bound`.

The same spawn also runs ``tests/test_torch_tensor_parallel.py``'s cases
(``torch_dist_worker.spawn_ranks`` runs the ranks once per test process)."""

import math

import pytest
import torch

import torch_dist_worker as W
from repro_torch.core import shard as SH
from repro_torch.core import sweep as PS
from repro_torch.parallel import pipeline as PP
from torch_parity import one_torch_thread  # noqa: F401

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results, in rank order."""
    return W.spawn_ranks(tmp_path_factory.mktemp("ranks"))


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
# the cells on the 4 x 1 and 2 x 2 ("data", "model") meshes of the 4 ranks
# --------------------------------------------------------------------------

MESHES = sorted(W.CELL_MESHES)


@pytest.fixture(scope="module")
def cell_reference():
    """The unsharded model of the ranks' cells, with their inputs."""
    cfg, model = W.cell_model()
    return cfg, model, W.cell_inputs(cfg)


def dp_width(mesh: str) -> int:
    return W.CELL_MESHES[mesh]["data"]


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


def dp_shards(rows: int, mesh: str) -> int:
    """How many DP shards a batch of ``rows`` splits into on ``mesh`` (the
    inputs' rule: the DP width where it divides the batch, else none)."""
    dp = dp_width(mesh)
    return dp if rows % dp == 0 else 1


def shard_of(full: torch.Tensor, spec: tuple, coordinate: tuple, mesh: str) -> torch.Tensor:
    """The block of ``full`` that the mesh coordinate holds under ``spec``
    (even splits; a tuple entry splits major axis first)."""
    sizes = W.CELL_MESHES[mesh]
    axes = list(sizes)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else entry
        index, n = 0, 1
        for a in names:
            index = index * sizes[a] + coordinate[axes.index(a)]
            n *= sizes[a]
        full = full.chunk(n, dim=d)[index]
    return full


def gamma(k: int, dtype) -> float:
    """Higham's gamma_k = k u / (1 - k u) for ``dtype``'s unit roundoff u."""
    ku = k * torch.finfo(dtype).eps / 2
    return ku / (1 - ku)


def chained_products(cfg, backward: bool = False) -> int:
    """The products on the cell model's longest path: per block q/k/v,
    the scores, PV, ``wo``, the FFN in and out; then the head. The
    backward runs each twice more (its two operands' gradients)."""
    forward = 6 * cfg.n_layers + 1
    return 3 * forward if backward else forward


def reordered_bound(cfg, scale: float, backward: bool = False) -> float:
    """How far the 2 x 2 cells may lie from the step without a mesh. Both
    are float32 evaluations of one function; the "model" split changes
    the order in which products sum their terms (the row-parallel ``wo``
    and FFN out over the two ranks, the vocab-parallel loss, and the CPU
    GEMM's own blocking of operands of another width). Each product sums
    at most n = max(d, f, Vp) terms, within gamma_n of the exact sum
    (relative to its terms' magnitudes, which these seeded layers keep at
    the scale of their result) in either order; carried to the output
    with gain at most one a product (pre-norm residual blocks, softmax
    and RMSNorm contract), the two evaluations differ by at most 2 K
    gamma_n x ``scale`` (the compared quantity's largest |value|), K the
    products chained on the path (:func:`chained_products`)."""
    n = max(cfg.d_model, cfg.d_ff, cfg.vocab_padded)
    return 2 * chained_products(cfg, backward) * gamma(n, torch.float32) * scale


def assert_cell_close(got: torch.Tensor, want: torch.Tensor, mesh: str, cfg, what,
                      backward: bool = False) -> None:
    """Bit-equal on 4 x 1; within :func:`reordered_bound` on 2 x 2."""
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if W.CELL_MESHES[mesh]["model"] == 1:
        assert torch.equal(got, want), what
        return
    limit = reordered_bound(cfg, float(want.abs().max()), backward)
    gap = float((got - want).abs().max())
    assert gap <= limit, (what, gap, limit)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ["prefill 1", "prefill 2"])
def test_prefill_cell_on_a_mesh_equals_the_unsharded_model(ranks, cell_reference, name, mesh):
    """Placements applied: every rank's gathered logits equal the unsharded
    prefill step's (each DP shard's rows against the step on those rows,
    where the DP width divides the batch), bit for bit on 4 x 1, within
    :func:`reordered_bound` on 2 x 2."""
    from repro_torch.launch.steps import make_prefill_step

    cfg, model, inputs = cell_reference
    step = make_prefill_step(cfg)
    batch = inputs[name]
    n = dp_shards(batch["tokens"].shape[0], mesh)
    want = torch.cat([step(model, dp_rows(batch, i, n)) for i in range(n)])
    for res in ranks:
        assert_cell_close(res["cells"][mesh][name], want, mesh, cfg, name)


@pytest.mark.parametrize("mesh", MESHES)
def test_decode_cell_on_a_mesh_equals_the_unsharded_model(ranks, cell_reference, mesh):
    """The decode cell's logits and the cache row it wrote equal the
    unsharded decode step's on each DP shard of the batch and cache (on 4
    x 1 the batch of 2 does not divide the DP width: every rank decodes
    both rows, the cache's sequence split over "data" and gathered a layer
    at a time)."""
    from repro_torch.launch.steps import make_decode_step

    cfg, model, inputs = cell_reference
    inp, cache = inputs["decode"]
    step = make_decode_step(cfg)
    n = dp_shards(2, mesh)
    logits, rows = [], []
    for i in range(n):
        c = {k: v.chunk(n, dim=1)[i].clone() for k, v in cache.items()}
        out, c = step(model, dp_rows(inp, i, n), c)
        logits.append(out)
        rows.append({k: v[:, :, W.CELL_INDEX] for k, v in c.items()})
    for res in ranks:
        got, got_rows = res["cells"][mesh]["decode"]
        assert_cell_close(got, torch.cat(logits), mesh, cfg, "logits")
        for k in cache:
            assert_cell_close(got_rows[k], torch.cat([r[k] for r in rows], dim=1), mesh, cfg, k)


@pytest.mark.parametrize("mesh", MESHES)
def test_decode_cell_at_batch_1_on_a_mesh_equals_the_unsharded_model(ranks, cell_reference,
                                                                     mesh):
    """Batch 1 divides no DP width: the cache's sequence is split over
    "data" (its heads over "model" on 2 x 2). On 4 x 1 each layer gathers
    its rows (a "model" axis of one: the meshless code), bit-equal to the
    unsharded step; on 2 x 2 each rank writes and attends on its own rows
    and the partial softmaxes are combined over "data" (split-KV), within
    :func:`reordered_bound` (the split reorders two float32 sums of at
    most CELL_CACHE terms, inside its gamma_n)."""
    from repro_torch.launch.steps import make_decode_step

    cfg, model, inputs = cell_reference
    inp, cache = inputs["decode 1"]
    cache = {k: v.clone() for k, v in cache.items()}
    logits, cache = make_decode_step(cfg)(model, inp, cache)
    for res in ranks:
        got, got_rows = res["cells"][mesh]["decode 1"]
        assert_cell_close(got, logits, mesh, cfg, "logits")
        for k, v in cache.items():
            assert_cell_close(got_rows[k], v[:, :, W.CELL_INDEX], mesh, cfg, k)


def composition(cfg, model, batch, dp: int) -> tuple[dict, list, list]:
    """The cell's accumulator summed in one process: microbatch by
    microbatch, in order, the ``dp`` DP shards' gradients in rank order
    (((g_0 + g_1) + g_2) + ...) in float32. Returns it, each microbatch's
    loss (the DP shards' mean) and every (microbatch, DP shard) gradient."""
    from repro_torch.launch.steps import loss_and_grads

    accum, losses, terms = None, [], []
    for i in range(2):
        mb = {k: v[i] for k, v in batch.items()}
        parts = [loss_and_grads(cfg, model, dp_rows(mb, r, dp)) for r in range(dp)]
        step_sum = {}
        for k in parts[0][1]:
            step_sum[k] = parts[0][1][k].float().clone()
            for _, grads in parts[1:]:
                step_sum[k] += grads[k].float()
        accum = step_sum if accum is None else {k: accum[k] + g for k, g in step_sum.items()}
        losses.append(sum(p[0] for p in parts) / dp)
        terms += [grads for _, grads in parts]
    return accum, losses, terms


@pytest.mark.parametrize("mesh", MESHES)
def test_zero_accumulator_shards_equal_the_single_process_composition(ranks, cell_reference,
                                                                      mesh):
    """Each rank's accumulator shard against its block of an accumulator
    summed in one process, microbatch by microbatch in order, the DP
    shards' gradients in rank order in float32 (the order the cell's
    all-to-all sums them in): bit-equal on 4 x 1, within the backward's
    :func:`reordered_bound` of each leaf on 2 x 2. The moments' ZeRO rule
    shards the large leaves over "data" too; the loss is the mean over
    microbatches and DP shards."""
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import params_sharding

    cfg, model, inputs = cell_reference
    dp = dp_width(mesh)
    accum, losses, _ = composition(cfg, model, inputs["train"], dp)
    specs = params_sharding(adamw_init(dict(model.named_parameters())), W.CELL_MESHES[mesh],
                            fsdp=True)["mu"]
    assert any("data" in s.spec for s in specs.values())  # ZeRO shards some leaves over DP
    for res in ranks:
        cells = res["cells"][mesh]
        for k, got in cells["accum"].items():
            want = shard_of(accum[k], specs[k].spec, cells["coordinate"], mesh)
            limit = reordered_bound(cfg, float(accum[k].abs().max()), backward=True)
            if W.CELL_MESHES[mesh]["model"] == 1:
                assert got.shape == want.shape and torch.equal(got, want), k
            else:
                assert got.shape == want.shape and float((got - want).abs().max()) <= limit, k
        loss = float(sum(losses) / 2)
        limit = 1e-6 if W.CELL_MESHES[mesh]["model"] == 1 else \
            1e-6 + reordered_bound(cfg, abs(loss))
        assert abs(float(cells["accum loss"]) - loss) <= limit


@pytest.mark.parametrize("mesh", MESHES)
def test_train_cell_leaves_the_ranks_equal(ranks, cell_reference, mesh):
    """After one train step with ``accum_shardings``, every rank holds the
    same parameters (each gathered from the updated shards), different
    from the initial ones and finite, and the same loss and norm."""
    _, model, _ = cell_reference
    first = ranks[0]["cells"][mesh]["train"]
    init = dict(model.named_parameters())
    for k, p in first["params"].items():
        assert torch.isfinite(p).all() and not torch.equal(p, init[k]), k
    for res in ranks[1:]:
        got = res["cells"][mesh]["train"]
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


def assert_first_step_within(got: dict, state: dict, params: dict, grads: dict, tol: dict,
                             s: float, opt_cfg) -> None:
    """A first AdamW step on gradients ``tol`` apart (per leaf, elementwise
    bound T), clipped by the same scale s: mu = (1 - b1) s g within (1 -
    b1) s T; nu = (1 - b2) (s g)^2 within (1 - b2) s^2 (2 |g| T + T^2);
    the update lr (s g / (s |g| + eps) + wd p) within lr 4 eps T / (s g^2)
    where |g| > 2 T (its sensitivity to g), within 2 lr elsewhere; each
    with 4 u of its value for the roundings."""
    u = torch.finfo(torch.float32).eps / 2
    b1, b2, lr, eps = opt_cfg.b1, opt_cfg.b2, opt_cfg.lr, opt_cfg.eps
    for k, g in grads.items():
        T, g = tol[k], g.float().abs()
        mu, nu = state["mu"][k], state["nu"][k]
        limit = (1 - b1) * s * T * (1 + 4 * u) + 4 * u * mu.abs()
        assert bool(((got["mu"][k] - mu).abs() <= limit).all()), ("mu", k)
        limit = (1 - b2) * s * s * (2 * g * T + T * T) * (1 + 4 * u) + 4 * u * nu
        assert bool(((got["nu"][k] - nu).abs() <= limit).all()), ("nu", k)
        far = g > 2 * T
        limit = torch.where(far, lr * 4 * eps * T / (s * torch.where(far, g, 1.0) ** 2),
                            2 * lr) + 4 * u * params[k].abs()
        assert bool(((got["params"][k] - params[k]).abs() <= limit).all()), ("params", k)


@pytest.mark.parametrize("mesh", MESHES)
def test_train_cell_values_equal_the_unsharded_step(ranks, cell_reference, mesh):
    """The values of the train step (2 microbatches, DP 4 or 2), each
    gathered whole on rank 0 (the ranks agree: the test above):

    (a) the parameters, both moments and the step counter against the
        unsharded ``adamw_update`` (the update ``make_train_step``
        applies) on the one-process composition's gradient, accumulator /
        (N x DP), clipped by the cell's own norm: bit-equal on 4 x 1; on 2
        x 2, where the gradient lies within the backward's
        :func:`reordered_bound` T of the composition's, each value within
        a first step's sensitivity to T (:func:`assert_first_step_within`);
    (b) that norm is within :func:`norm_bound` of the composition's norm
        (on 2 x 2 plus the norm of T): each leaf's shard sums, the sums
        over the ranks and over the leaves are the only sums;
    (c) the unsharded ``make_train_step`` on the same rows, as N x DP
        microbatches of one DP shard each in the cell's order, sums the
        same K gradients g_k in another order: |g - g'| <= delta =
        2 (K - 1) u sum_k |g_k| / K. Its norm is within the same bound
        plus |delta|, and its first moment (1 - b1) fl(g' s') within
        (1 - b1) (s delta + |s - s'| |g'| + gamma_2 (s |g| + s' |g'|))
        of the cell's, s and s' the clip scales of the two norms (on 2 x 2
        with T added to delta). Its loss, a mean of the same K losses, is
        within the K-term sum's bound (on 2 x 2 plus the forward's
        :func:`reordered_bound` of the loss)."""
    from repro_torch.core.quantization import true_divide
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    cfg, model, inputs = cell_reference
    dp, tp = dp_width(mesh), W.CELL_MESHES[mesh]["model"] > 1
    got = ranks[0]["cells"][mesh]["train"]
    accum, losses, terms = composition(cfg, model, inputs["train"], dp)
    K = 2 * dp
    grads = {k: true_divide(a, float(K)) for k, a in accum.items()}
    tol = {k: reordered_bound(cfg, float(g.abs().max()), backward=True) if tp else 0.0
           for k, g in grads.items()}
    opt_cfg = AdamWConfig()
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    _, state, metrics = adamw_update(grads, adamw_init(params), params, opt_cfg,
                                     grad_norm=got["metrics"]["grad_norm"])
    if tp:  # (a)
        s = clip_scale(got["metrics"]["grad_norm"], opt_cfg.grad_clip_norm)
        assert_first_step_within(got, state, params, grads, tol, s, opt_cfg)
    else:
        for k in params:
            assert torch.equal(got["params"][k], params[k]), k
            assert torch.equal(got["mu"][k], state["mu"][k]), k
            assert torch.equal(got["nu"][k], state["nu"][k]), k
    assert torch.equal(got["step"], state["step"])
    assert torch.equal(got["metrics"]["lr"], metrics["lr"])

    exact, bound = norm_bound(grads, 4 + len(grads))  # (b)
    t_norm = math.sqrt(sum(tol[k] ** 2 * g.numel() for k, g in grads.items()))
    norm = got["metrics"]["grad_norm"]
    assert abs(float(norm) - exact) <= bound + t_norm, (float(norm), exact, bound)

    batch = {k: torch.stack([dp_rows({k: v[i]}, r, dp)[k] for i in range(2) for r in range(dp)])
             for k, v in inputs["train"].items()}  # (c)
    _, fresh = W.cell_model()
    opt = adamw_init(dict(fresh.named_parameters()))
    _, opt, plain = make_train_step(cfg, opt_cfg, n_microbatches=K)(fresh, opt, batch)
    u = torch.finfo(torch.float32).eps / 2
    delta = {k: 2 * (K - 1) * u * sum(t[k].float().abs() for t in terms) / K + tol[k]
             for k in grads}
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
    loss_gap = abs(float(plain["loss"]) - float(got["metrics"]["loss"]))
    loss_limit = 2 * gamma(K, torch.float32) * sum(abs(float(x)) for x in losses)
    if tp:
        loss_limit += reordered_bound(cfg, abs(float(plain["loss"])))
    assert loss_gap <= loss_limit
