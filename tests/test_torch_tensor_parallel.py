"""The tensor-parallel compute plan (``repro_torch.parallel.tensor_parallel``)
over 4 ``gloo`` ranks on the CPU, in float32. Each pair of ranks is a
(1, 2) ("data", "model") mesh (``torch_dist_worker.TP_MESH``: a replica
axis over two such meshes), so every rank splits heads, FFN hidden and
vocab two ways. The ranks run in the spawn that
``tests/test_torch_distributed.py`` reads (``torch_dist_worker.spawn_ranks``:
once per test process).

* Layer by layer (:data:`torch_dist_worker.TP_LAYERS`): the embedding
  (tokens and codebooks), attention with the heads local, with k/v whole
  (MQA; GQA whose local q heads read kv heads unevenly) and replicated
  (H odd), the gated and GELU MLPs and a replicated one (f odd), the
  parallel residual, the vocab-parallel head with its loss and gradients
  (one codebook split across the ranks) and a replicated head (Vp odd),
  each against the same layer unsharded in this process: the embedding
  bit for bit, the rest within :func:`layer_bound`.
* Whole cells against the JAX package: prefill logits, decode logits with
  the cache row written, and a training microbatch's loss and gradients
  of reduced deepseek-7b, stablelm-12b (GQA, parallel residual),
  granite-34b (MQA, f odd), musicgen (3 heads, 3 codebooks) and
  deepseek-7b with an odd vocab, each against the reference's meshless
  ``forward`` / ``serve_step`` / ``jax.grad(loss_fn)`` on the same
  weights: logits and cache rows within ``LM_F32_TOL``, the loss within
  rtol 1e-5, each gradient leaf within ``GRAD_RTOL`` of its largest
  |value| (``torch_parity``: the tolerances of the meshless parity tests,
  whose float32 sums the split only reorders).
* Memory: while the cell model (FSDP: its embedding and head also split
  over "data") takes a train step and a prefill step on the 2 x 2 mesh,
  no rank holds more gathered leaves at once than the largest layer's,
  and no rank gathers a leaf its layer computes on in shards.
* The plan's rules: outside a context every collective is the identity;
  the kv heads a rank reads follow GQA's grouping; at full size on a
  16-wide "model" axis every leaf a layer computes on in shards is stored
  split on that dim (used in place), for all ten configs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from repro.configs import get_config as ref_get_config
from repro.models import transformer as RT
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.parallel import tensor_parallel as TP
from torch_parity import LM_F32_TOL, assert_grads_close, one_torch_thread, ref_state  # noqa: F401


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results, in rank order."""
    return W.spawn_ranks(tmp_path_factory.mktemp("ranks"))


def gamma(k: int) -> float:
    """Higham's gamma_k for float32's unit roundoff."""
    ku = k * torch.finfo(torch.float32).eps / 2
    return ku / (1 - ku)


# products chained in each layer kind's output, and twice more for a
# gradient (each product's two operands)
LAYER_PRODUCTS = {"attn": 4, "mlp": 2, "block": 6, "head": 1,
                  # the router, the experts' in and out, the float32 combine
                  "moe": 4,
                  # q, the scores, P·V and wo; MLA: q down and up, q absorbed,
                  # the scores, P·V, the latent's up-projection and wo
                  "decode": 4, "mla decode": 7}


def layer_bound(cfg, kind: str, scale: float, backward: bool = False) -> float:
    """How far a layer on the (1, 2) mesh may lie from the same layer
    unsharded: every product may sum its at most n = max(d, f, Vp, S)
    terms in another order (the row-parallel ``wo`` and FFN out over the
    two ranks, the vocab-parallel loss, the CPU GEMM's blocking of an
    operand of half the width), each order within gamma_n of the exact
    sum relative to its terms' magnitudes, which these seeded layers keep
    at the scale of the result; K chained products carry it with gain at
    most one: 2 K gamma_n x ``scale`` (the quantity's largest |value|)."""
    n = max(cfg.d_model, cfg.d_ff, cfg.vocab_padded, W.TP_SEQ)
    k = LAYER_PRODUCTS[kind] + (1 if kind == "head" else 0)  # the loss's sum
    return 2 * (3 * k if backward else k) * gamma(n) * scale


@pytest.mark.parametrize("case,name,kind", W.TP_LAYERS, ids=[c[0] for c in W.TP_LAYERS])
def test_layer_on_the_model_axis_equals_the_unsharded_layer(ranks, case, name, kind):
    cfg = W.tp_config(name)
    layer, _ = W.tp_layer(kind, cfg)
    want = W.run_tp_layer(kind, cfg, layer, W.tp_layer_inputs(kind, cfg, case=case))
    for res in ranks:
        got = res["tensor parallel"]["layers"][case]
        assert sorted(got) == sorted(want), case
        for k, w in want.items():
            g = got[k]
            assert g.shape == w.shape and g.dtype == w.dtype, (case, k)
            if kind == "embed" or not w.is_floating_point():
                # columns looked up and gathered; the experts picked (every
                # rank routes the same tokens alike); int8 codes of a k or v
                # computed whole: exact
                assert torch.equal(g, w), (case, k)
                continue
            limit = layer_bound(cfg, kind, float(w.abs().max()), backward=k.startswith("d"))
            gap = float((g - w).abs().max())
            assert gap <= limit, (case, k, gap, limit)


@pytest.mark.parametrize("case,name,kind", W.TP_LAYERS, ids=[c[0] for c in W.TP_LAYERS])
def test_layer_on_a_model_axis_of_one_is_the_meshless_layer(ranks, case, name, kind):
    """On a "model" axis of one rank (``TP_MESH_ONE``) every layer runs its
    meshless code under the context: its outputs, gradients, picks and
    written cache equal the unsharded layer's bit for bit."""
    cfg = W.tp_config(name)
    layer, _ = W.tp_layer(kind, cfg)
    want = W.run_tp_layer(kind, cfg, layer, W.tp_layer_inputs(kind, cfg, case=case))
    for res in ranks:
        got = res["tensor parallel"]["layers m1"][case]
        assert sorted(got) == sorted(want), case
        for k, w in want.items():
            assert got[k].dtype == w.dtype and torch.equal(got[k], w), (case, k)


@pytest.mark.parametrize("name", list(W.TP_CONFIGS))
def test_cells_on_a_model_axis_of_one_are_the_meshless_steps(ranks, name):
    """Each config's cells on ``TP_MESH_ONE`` (a "model" axis of one, DP
    width one): prefill logits, decode logits with the written cache row,
    and the training microbatch's loss and gradients equal the port's
    steps without a mesh on the same weights, bit for bit."""
    from repro_torch.launch.steps import loss_and_grads, make_decode_step, make_prefill_step

    cfg = W.tp_config(name)
    model = W.tp_model(cfg)
    inputs = W.tp_inputs(cfg)
    prefill = make_prefill_step(cfg)(model, inputs["prefill"])
    inp, cache = inputs["decode"]
    logits, cache = make_decode_step(cfg)(model, inp, cache)
    rows = {k: v[:, :, W.TP_INDEX] for k, v in cache.items()}
    loss, grads = loss_and_grads(cfg, model, inputs["train"])
    for res in ranks:
        got = res["tensor parallel"]["cells m1"][name]
        assert torch.equal(got["prefill"], prefill), name
        got_logits, got_rows = got["decode"]
        assert torch.equal(got_logits, logits), name
        assert sorted(got_rows) == sorted(rows), name
        for k, row in rows.items():
            assert torch.equal(got_rows[k], row), (name, k)
        got_loss, got_grads = got["train"]
        assert torch.equal(got_loss, loss), name
        assert sorted(got_grads) == sorted(grads), name
        for k, g in grads.items():
            assert torch.equal(got_grads[k], g.to(got_grads[k].dtype)), (name, k)


def test_moe_cases_drop_pairs_and_split_as_planned():
    """The MoE layer cases cover the plan's three branches at m = 2 (the
    experts, f, neither) and capacity drops."""
    TP._STACK.append(_on_axis(2, 0))
    try:
        plans = {name: TP.moe_plan(W.tp_config(name).n_experts, W.tp_config(name).d_ff)[0]
                 for _, name, kind in W.TP_LAYERS if kind == "moe"}
    finally:
        TP._STACK.pop()
    assert plans == {"granite-moe": {"w_in": -3, "w_gate": -3, "w_out": -3},
                     "granite-moe/E3": {"w_in": -1, "w_gate": -1, "w_out": -2},
                     "granite-moe/E3-f129": {}, "granite-moe/drops": plans["granite-moe"]}
    cfg = W.tp_config("granite-moe/drops")
    layer, _ = W.tp_layer("moe", cfg)
    picks = W.run_tp_layer("moe", cfg, layer, W.tp_layer_inputs("moe", cfg))["picks"]
    E, K, g = cfg.n_experts, cfg.top_k, picks.shape[1]
    C = -(-g * K * cfg.moe_capacity_factor // E)
    load = torch.bincount(picks.reshape(-1), minlength=E)
    assert int(torch.clamp_min(load - C, 0).sum()) > 0  # some expert overflows


@pytest.mark.parametrize("case", [c for c, _, kind in W.TP_LAYERS if "decode" in kind])
def test_split_kv_decode_gathers_no_cache_entry(ranks, case):
    """Each decode case's cache has its sequence split over "model" (the kv
    heads do not divide it, or an MLA latent): every rank writes and reads
    its own 8 of the 16 rows and no all-gather moves a cache entry (its
    local (2, 8, ...) block)."""
    _, name, kind = next(c for c in W.TP_LAYERS if c[0] == case)
    cfg = W.tp_config(name)
    cache = W.tp_layer_cache(cfg)
    from repro_torch.parallel.sharding import cache_sharding

    specs = cache_sharding(cfg, cache, {"replica": 2, "data": 1, "model": 2}, 2)
    local = set()
    for k, t in cache.items():
        assert specs[k].spec[1] == "model", (case, k, specs[k].spec)
        local.add((t.shape[0], t.shape[1] // 2, *t.shape[2:]))
    for res in ranks:
        moved = set(res["tensor parallel"]["layer gathers"][case])
        assert not moved & local, (case, moved)


# --------------------------------------------------------------------------
# whole cells against the JAX package
# --------------------------------------------------------------------------


def ref_params(model) -> dict:
    """The reference's parameter pytree (numpy) of a homogeneous port
    model: ``convert.lm_params_from_reference`` backwards, each per-layer
    leaf stacked over the layers."""
    tree, stacks = {}, {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        if parts[0] == "blocks":
            stacks.setdefault(tuple(parts[2:]), {})[int(parts[1])] = t.numpy()
        else:
            tree.setdefault(parts[0], {})[parts[1]] = t.numpy()
    blocks = tree["blocks"] = {}
    for path, layers in stacks.items():
        node = blocks
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([layers[i] for i in range(len(layers))])
    return tree


@pytest.fixture(scope="module")
def jax_cells():
    """Every :data:`TP_CONFIGS` config's cells run by the reference without
    a mesh on the port's weights: the last position's prefill logits, the
    decode logits and the cache row written, the loss and its gradients
    (as the port's ``{name: tensor}``)."""
    out = {}
    for name, (arch, over) in W.TP_CONFIGS.items():
        cfg = W.tp_config(name)
        rcfg = ref_get_config(arch).reduced(**over)
        model = W.tp_model(cfg)
        params = jax.tree.map(jnp.asarray, ref_params(model))
        inputs = W.tp_inputs(cfg)
        as_jax = lambda d: {k: jnp.asarray(v.numpy()) for k, v in d.items()}  # noqa: E731
        logits, _ = RT.forward(rcfg, params, as_jax(inputs["prefill"]))
        inp, cache = inputs["decode"]
        dec, new = RT.serve_step(rcfg, params, as_jax(inp), as_jax(cache))
        batch = as_jax(inputs["train"])
        loss, grads = jax.value_and_grad(lambda p: RT.loss_fn(rcfg, p, batch))(params)
        out[name] = {"prefill": np.asarray(logits[:, -1]), "decode": np.asarray(dec),
                     "rows": {k: np.asarray(v[:, :, W.TP_INDEX]) for k, v in new.items()},
                     "loss": float(loss), "grads": ref_state(cfg, grads)}
    return out


@pytest.mark.parametrize("name", list(W.TP_CONFIGS))
def test_cells_on_the_model_axis_equal_the_jax_reference(ranks, jax_cells, name):
    want = jax_cells[name]
    for res in ranks:
        got = res["tensor parallel"]["cells"][name]
        np.testing.assert_allclose(got["prefill"].numpy(), want["prefill"], **LM_F32_TOL,
                                   err_msg=f"{name} prefill")
        logits, rows = got["decode"]
        np.testing.assert_allclose(logits.numpy(), want["decode"], **LM_F32_TOL,
                                   err_msg=f"{name} decode")
        for k, row in rows.items():
            np.testing.assert_allclose(row.numpy(), want["rows"][k], **LM_F32_TOL,
                                       err_msg=f"{name} cache row {k}")
        loss, grads = got["train"]
        assert abs(float(loss) - want["loss"]) <= 1e-5 * abs(want["loss"]), name
        assert_grads_close(grads, want["grads"], name)


@pytest.mark.parametrize("name", list(W.TP_CONFIGS))
def test_decode_cells_gather_no_cache_entry(ranks, name):
    """No all-gather of a decode cell moves a layer's cache entry: entries
    split by heads are read as stored, and entries whose sequence is split
    over "model" (granite-34b's one kv head, stablelm's 3 and musicgen's 3
    on 2 ranks, minicpm3's latents) are written and attended in place."""
    cfg = W.tp_config(name)
    for res in ranks:
        cell = res["tensor parallel"]["cells"][name]
        entries = set(cell["decode cache"].values())
        assert not set(cell["decode gathers"]) & entries, (name, cell["decode gathers"])
        if name in ("granite-34b", "stablelm-12b", "musicgen-medium", "minicpm3"):
            rows = {shape[1] for shape in entries}
            assert rows == {W.TP_CACHE // 2}, (name, entries)  # the sequence split, kept
    assert cfg.n_layers == 2


# --------------------------------------------------------------------------
# memory
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["train", "prefill 2"])
def test_no_rank_holds_more_than_one_layers_gathered_leaves(ranks, kind):
    """Every tensor the leaf gather made on the 2 x 2 mesh, live at once at
    most the largest layer's gathered leaves (``gathered_bytes``'s
    ``params``), all released after the step; the embedding and the head
    (split over "data" too) are gathered over "data" only, keeping their
    "model" shard: no gathered tensor has the shape of a whole leaf that
    its spec splits over "model" (every leaf of the cell model is
    computed on in shards at m = 2)."""
    _, model = W.cell_model()
    whole = {tuple(p.shape) for p in model.parameters()}
    for res in ranks:
        mem = res["tensor parallel"]["memory"][kind]
        assert mem["made"], kind  # the FSDP leaves were gathered over "data"
        assert 0 < mem["peak"] <= mem["largest layer"], (kind, mem["peak"], mem["largest layer"])
        assert mem["live after"] == 0, kind
        assert not set(mem["made"]) & whole, (kind, mem["made"])


# --------------------------------------------------------------------------
# the plan's rules
# --------------------------------------------------------------------------


def test_outside_a_context_every_collective_is_the_identity():
    x = torch.randn(2, 3, 4)
    part = TP.row_parallel(x, torch.randn(4, 5))
    assert TP.current() is None and TP.model_size() == 1 and not TP.splits(16)
    assert TP.copy_to_model(x) is x and TP.gather_from_model(x, -1) is x
    assert TP.reduce_from_model(x) is x
    assert torch.equal(TP.reduce(part, torch.float32), part.value)
    a, f = torch.randn(2, 3, 4), torch.randn(2, 3, 4)
    assert torch.equal(TP.residual(x, a, f), x + a + f)
    cache = {"k": torch.zeros(1)}
    with TP.layer_cache(cache) as c:
        assert c is cache
    layer = torch.nn.Linear(2, 2)
    with TP.gathered(layer) as m:
        assert m is layer and isinstance(m.weight, torch.nn.Parameter)
    assert TP.local_state(cache, cache) is cache


def _on_axis(m: int, rank: int):
    return TP.TPContext(mesh=None, sizes={"data": 1, "model": m}, coords={"data": 0,
                                                                          "model": rank})


@pytest.mark.parametrize("H,Hkv,m,rank,want", [
    (32, 32, 16, 5, slice(10, 12)),   # MHA: two heads each
    (32, 8, 16, 5, slice(2, 3)),      # stablelm: 2 q heads of a group of 4
    (48, 1, 16, 7, slice(0, 1)),      # granite-34b MQA: 3 q heads, the one kv head
    (64, 8, 16, 3, slice(1, 2)),      # qwen2-vl: 4 q heads of a group of 8
    (6, 3, 2, 0, [0, 0, 1]),          # uneven: one kv head per q head
    (6, 3, 2, 1, [1, 2, 2]),
])
def test_kv_heads_follow_the_gqa_grouping(H, Hkv, m, rank, want):
    TP._STACK.append(_on_axis(m, rank))
    try:
        got = TP.kv_heads(H, Hkv)
    finally:
        TP._STACK.pop()
    assert got == want
    local = H // m
    idx = range(Hkv)[got] if isinstance(got, slice) else got
    group = local // len(idx) if isinstance(got, slice) else 1
    assert [list(idx)[j // group] for j in range(local)] == \
        [(rank * local + j) // (H // Hkv) for j in range(local)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaves_computed_in_shards_are_stored_split_there(arch):
    """On the production mesh's 16-wide "model" axis, every leaf whose
    layer computes on its "model" shard (``leaf_plan``) is stored split on
    that very dim by the reference's rules (``params_sharding``): used in
    place, never gathered over "model" (training's layout and serving's)."""
    from repro_torch.launch.steps import abstract_state
    from repro_torch.parallel.sharding import params_sharding

    cfg = get_config(arch)
    params = abstract_state(cfg, with_opt=False)
    TP._STACK.append(_on_axis(16, 0))
    try:
        plans = {k: TP.leaf_plan(cfg, k) for k in params}
    finally:
        TP._STACK.pop()
    kept = {k: keep for k, (keep, _) in plans.items() if keep is not None}
    assert kept or cfg.use_mla or cfg.is_moe or cfg.block_pattern, arch
    for fsdp in (False, True):
        specs = params_sharding(params, {"data": 16, "model": 16}, fsdp=fsdp)
        for k, keep in kept.items():
            spec = specs[k].spec + (None,) * (params[k].dim() - len(specs[k].spec))
            assert spec[keep % params[k].dim()] == "model", (arch, k, spec)
    if not cfg.use_mla and cfg.n_heads % 16 == 0:
        assert any(k.endswith("attn.wq") for k in kept), arch
    # the MoE's expert stacks, by the experts where 16 divides E
    experts = [k for k in params if cfg.is_moe and ".ff.w_" in k]
    assert all(kept.get(k) == -3 for k in experts) and bool(experts) == cfg.is_moe, arch
