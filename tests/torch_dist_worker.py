"""The body of one rank of ``tests/test_torch_distributed.py`` and
``tests/test_torch_tensor_parallel.py`` (imported by the spawned processes;
not collected). It imports torch, numpy and ``repro_torch`` only, runs every
distributed case on the CPU with the ``gloo`` backend, and pickles its
results to ``<out_dir>/rank<r>.pkl``. :func:`spawn_ranks` runs the ranks
once per test process for both files."""

import os
import pickle
import time
import weakref

import numpy as np
import torch

INF = float("inf")
WORLD = 4
# (label, S, N, L, combine, n_shards, all-k): 7 and 65 scenarios pad to 8 and 68
DP_CASES = [("S7-sum", 7, 4, 9, "sum", None, False),
            ("S65-max", 65, 5, 10, "max", None, False),
            ("S65-3-shards", 65, 4, 9, "sum", 3, False),
            ("S7-all-k", 7, 4, 9, "sum", None, True)]
TOY = dict(L=8, D=16, M=6, mb=2)
TOY_SPLITS = {"uniform": (2, 4, 6), "uneven": (3, 5, 7)}


def make_C(S, N, L, seed, inf_frac=0.15):
    rng = np.random.RandomState(seed)
    C = rng.randint(1, 41, size=(S, N, L, L)) / 4.0
    C[rng.random_sample(C.shape) < inf_frac] = INF
    il = np.tril_indices(L, -1)
    C[:, :, il[0], il[1]] = INF
    return C


def dp_inputs(S, N, L):
    C = make_C(S, N, L, seed=S + N)
    ns = np.random.RandomState(S).randint(1, N + 1, size=S)
    return C, ns


def toy_inputs():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(TOY["L"], TOY["D"], TOY["D"], generator=g) * 0.1
    x = torch.randn(TOY["M"], TOY["mb"], TOY["D"], generator=g)
    return {"w": w}, x


def toy_block(lp, x):
    return x + x @ lp["w"]


class Plan:
    def __init__(self, splits):
        self.splits = tuple(splits)


def deepseek_inputs():
    """reduced() deepseek-7b with 8 layers (seeded weights), its stacked
    blocks, a block_apply and 4 microbatches of 2 x 12 rows."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as PT
    from repro_torch.parallel import pipeline as PP

    cfg = get_config("deepseek-7b").reduced(n_layers=8)
    model = PT.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    pos = torch.arange(12, dtype=torch.int32).expand(2, 12)
    x = torch.randn(4, 2, 12, cfg.d_model, generator=torch.Generator().manual_seed(1))
    return PP.stack_blocks(model), PP.transformer_block_apply(model, cfg, pos), x


def pipeline_refusals(group) -> dict:
    """The group form under autograd, each case's ``RuntimeError`` message
    (``None`` if it ran): stage parameters that require grad, an input
    that does, and the same under ``torch.no_grad()`` (which runs). Every
    rank refuses before its first send, so no rank waits on another."""
    from repro_torch.parallel import pipeline as PP

    params, x = toy_inputs()
    plan = Plan(TOY_SPLITS["uniform"])
    cases = {"params": ({"w": params["w"].clone().requires_grad_(True)}, x),
             "input": (params, x.clone().requires_grad_(True))}
    out = {}
    for name, (p, xin) in cases.items():
        try:
            PP.run_pipeline(plan, toy_block, p, TOY["L"], xin, group=group)
            out[name] = None
        except RuntimeError as e:
            out[name] = str(e)
    with torch.no_grad():
        p, xin = cases["params"]
        out["no_grad"] = PP.run_pipeline(plan, toy_block, p, TOY["L"], xin, group=group)
    return out


# the cells on two ("data", "model") meshes of the 4 ranks: 4 x 1, where the
# tensor-parallel plan is the identity, and 2 x 2. A reduced deepseek-7b wide
# enough that the ZeRO rule (leaves of >= 2^22 bytes at 4 bytes an element)
# shards the embedding's and the head's moments over "data"
CELL_MESHES = {"4x1": {"data": 4, "model": 1}, "2x2": {"data": 2, "model": 2}}
CELL_SEQ, CELL_CACHE, CELL_INDEX = 8, 16, 6


def cell_model():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as PT

    cfg = get_config("deepseek-7b").reduced(n_layers=4, d_model=256, d_ff=1024, vocab=4096,
                                            train_microbatches=2)
    return cfg, PT.init_params(cfg, generator=torch.Generator().manual_seed(5), device="cpu")


def cell_inputs(cfg) -> dict:
    """Seeded inputs of the cells: prefill at batch 1 (not DP-sharded) and
    2, decode at batch 2 over a random cache, train as 2 microbatches of 4
    rows (one or two rows a DP rank)."""
    from repro_torch.models import transformer as PT

    g = torch.Generator().manual_seed(6)
    tok = lambda *shape: torch.randint(0, cfg.vocab, shape, generator=g, dtype=torch.int32)  # noqa: E731
    cache = PT.init_cache(cfg, 2, CELL_CACHE, device="cpu")
    for t in cache.values():
        t.normal_(generator=g)
    cells = {"prefill 1": {"tokens": tok(1, CELL_SEQ)},
             "prefill 2": {"tokens": tok(2, CELL_SEQ)},
             "decode": ({"tokens": tok(2, 1), "cur_index": torch.tensor(CELL_INDEX,
                                                                        dtype=torch.int32)},
                        cache),
             "train": {"tokens": tok(2, 4, CELL_SEQ), "labels": tok(2, 4, CELL_SEQ)}}
    # batch 1: on 2 x 2 the cache's sequence is split over "data", not its batch
    one = PT.init_cache(cfg, 1, CELL_CACHE, device="cpu")
    for t in one.values():
        t.normal_(generator=g)
    cells["decode 1"] = ({"tokens": tok(1, 1), "cur_index": torch.tensor(CELL_INDEX,
                                                                         dtype=torch.int32)}, one)
    return cells


def cell_shapes():
    from repro_torch.configs import ShapeSpec

    return {"prefill 1": ShapeSpec("prefill", "prefill", CELL_SEQ, 1),
            "prefill 2": ShapeSpec("prefill", "prefill", CELL_SEQ, 2),
            "decode": ShapeSpec("decode", "decode", CELL_CACHE, 2),
            "decode 1": ShapeSpec("decode", "decode", CELL_CACHE, 1),
            "train": ShapeSpec("train", "train", CELL_SEQ, 8)}


def cell_cases(mesh_name: str) -> dict:
    """The cells on mesh ``mesh_name`` of the 4 ranks, every argument laid
    out by its sharding: gathered prefill and decode logits (decode at
    batch 2 and 1), the cache row each decode wrote, this rank's ZeRO accumulator shards (two
    microbatches), and the parameters, moments and metrics after one train
    step, each gathered whole."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import sharding as SH

    mesh = make_host_mesh(model_parallel=CELL_MESHES[mesh_name]["model"], device="cpu")
    cfg, model = cell_model()
    inputs, shapes = cell_inputs(cfg), cell_shapes()
    params = dict(model.named_parameters())
    out = {"coordinate": tuple(mesh.get_coordinate())}
    for name in ("prefill 1", "prefill 2"):
        step, _, (p_sh, b_sh) = ST.build_cell(cfg, shapes[name], mesh)
        out[name] = step(SH.distribute(params, p_sh), SH.distribute(inputs[name], b_sh))
    for name in ("decode", "decode 1"):
        step, _, (p_sh, b_sh, c_sh) = ST.build_cell(cfg, shapes[name], mesh)
        inp, cache = inputs[name]
        cache = SH.distribute(cache, c_sh)
        logits, cache = step(SH.distribute(params, p_sh), SH.distribute(inp, b_sh), cache)
        out[name] = (logits, {k: v.full_tensor()[:, :, CELL_INDEX] for k, v in cache.items()})
    step, _, (p_sh, o_sh, b_sh) = ST.build_cell(cfg, shapes["train"], mesh)
    batch = SH.distribute(inputs["train"], b_sh)
    local = {k: v.to_local() for k, v in batch.items()}
    accum, loss = ST.zero_accumulated_grads(cfg, SH.distribute(params, p_sh), local, 2,
                                            o_sh["mu"])
    out["accum"] = {k: a.to_local() for k, a in accum.items()}
    out["accum loss"] = loss
    p_d = SH.distribute(params, p_sh)
    p_d, o_d, metrics = step(p_d, SH.distribute(adamw_init(params), o_sh), batch)
    out["train"] = {"params": {k: v.full_tensor() for k, v in p_d.items()},
                    **{m: {k: v.full_tensor() for k, v in o_d[m].items()} for m in ("mu", "nu")},
                    "step": o_d["step"].full_tensor(), "metrics": metrics}
    return out


def nodes(res) -> dict:
    if isinstance(res, dict):
        return {n: nodes(r) for n, r in res.items()}
    return {"splits": res.splits, "cost_s": res.cost_s, "feasible": res.feasible,
            "n_devices_s": res.n_devices_s, "backend": res.backend}


def solve_cases(mesh_spec) -> dict:
    from repro_torch.core import shard as SH

    out = {}
    for label, S, N, L, combine, n_shards, all_k in DP_CASES:
        C, ns = dp_inputs(S, N, L)
        kw = dict(return_all_k=True) if all_k else dict(n_devices=ns)
        out[label] = nodes(SH.sharded_optimal_dp(C, combine, n_shards=n_shards,
                                                 mesh_spec=mesh_spec, device="cpu", **kw))
    return out


def run_rank(rank: int, world: int, url: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as err:
        os.dup2(err.fileno(), 2)
    import torch.distributed as dist

    from repro_torch.core.spec import MeshSpec
    from repro_torch.core import sweep as PS
    from repro_torch.parallel import pipeline as PP

    results = {}
    # a spec with a coordinator brings the group up (once per process) ...
    spec = MeshSpec(kind="distributed", coordinator=url, num_processes=world,
                    process_id=rank)
    results["coordinator"] = solve_cases(spec)
    assert dist.is_initialized() and dist.get_world_size() == world
    # ... and a spec without one runs on the group the caller holds
    results["no coordinator"] = solve_cases(MeshSpec(kind="distributed"))
    C, ns = dp_inputs(13, 3, 7)
    results["batched_optimal_dp"] = nodes(PS.batched_optimal_dp(
        C, "sum", "sharded", n_devices=ns, mesh_spec=MeshSpec(kind="distributed"),
        device="cpu"))
    params, x = toy_inputs()
    results["pipeline"] = {
        name: PP.run_pipeline(Plan(splits), toy_block, params, TOY["L"], x,
                              group=dist.group.WORLD)
        for name, splits in TOY_SPLITS.items()}
    stacked, apply, x = deepseek_inputs()
    results["pipeline"]["deepseek-7b"] = PP.run_pipeline(
        Plan(TOY_SPLITS["uneven"]), apply, stacked, 8, x, group=dist.group.WORLD)
    results["pipeline refuses autograd"] = pipeline_refusals(dist.group.WORLD)
    results["cells"] = {name: cell_cases(name) for name in CELL_MESHES}
    results["tensor parallel"] = tp_cases()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# tensor parallel: layers and whole cells on a (1, 2) mesh, the memory held
# --------------------------------------------------------------------------

# ("replica", "data", "model"): each pair of ranks is a (1, 2) ("data",
# "model") mesh; the replica axis holds no shard of anything. TP_MESH_ONE:
# every rank alone on a "model" axis of one, where each layer runs its
# meshless code
TP_MESH = (2, 1, 2)
TP_MESH_ONE = (4, 1, 1)
# 3 rows: never the reduced configs' 2 layers, which the cache rule would
# take for the batch dim of a stacked cache
TP_BATCH, TP_SEQ, TP_CACHE, TP_INDEX = 3, 8, 16, 5
# reduced configs whose sizes show every branch of the plan at m = 2
TP_CONFIGS = {
    # H 4, Hkv 4, f 128, Vp 256: heads, kv heads, FFN hidden and vocab local
    "deepseek-7b": ("deepseek-7b", {}),
    # GQA H 6 on Hkv 3 (group 2): 3 q heads a rank, kv whole, each rank's
    # q heads read kv heads (0, 0, 1) and (1, 2, 2); the parallel residual
    "stablelm-12b": ("stablelm-12b", dict(n_heads=6, n_kv_heads=3)),
    # MQA: the one kv head whole, read by both local q heads of the group
    # of 4; f 129 does not divide: the MLP runs replicated
    "granite-34b": ("granite-34b", dict(d_ff=129)),
    # H 3 does not divide: the attention runs replicated; 3 codebooks x
    # Vp 256 over 2 ranks: a rank's vocab shard ends inside a codebook
    "musicgen-medium": ("musicgen-medium", dict(n_heads=3, n_kv_heads=3, n_codebooks=3)),
    # vocab 127, unpadded: Vp does not divide, the head runs replicated
    "deepseek-7b/vocab-127": ("deepseek-7b", dict(vocab=127, pad_vocab_to=0)),
    # E 4 top 2: two experts a rank (expert parallelism), kv heads local
    "granite-moe": ("granite-moe-1b-a400m", {}),
    # E 4 top 2 with H 4 on Hkv 4; the accumulator in float32 (the config's
    # bfloat16 would round the gradients this file holds to the reference)
    "qwen3-moe": ("qwen3-moe-235b-a22b", dict(grad_accum_dtype="float32")),
    # MLA, run replicated; its absorbed decode on a latent cache whose
    # sequence is split over "model"
    "minicpm3": ("minicpm3-4b", {}),
}
# configs of the layer cases only
TP_LAYER_CONFIGS = {
    # E 3 does not divide, f 128 does: every expert on its f columns
    "granite-moe/E3": ("granite-moe-1b-a400m", dict(n_experts=3)),
    # neither E 3 nor f 129 divides: the MoE runs replicated
    "granite-moe/E3-f129": ("granite-moe-1b-a400m", dict(n_experts=3, d_ff=129)),
    # capacity 4 a group for 32 picks: pairs drop
    "granite-moe/drops": ("granite-moe-1b-a400m", dict(moe_capacity_factor=0.5)),
    # MQA over the int8 cache: codes and scales split by sequence alike
    "granite-34b/int8": ("granite-34b", dict(kv_cache_dtype="int8")),
}


def tp_config(name: str):
    from repro_torch.configs import get_config

    arch, over = {**TP_CONFIGS, **TP_LAYER_CONFIGS}[name]
    return get_config(arch).reduced(**over)


def tp_model(cfg, seed: int = 11):
    from repro_torch.models import transformer as PT

    return PT.init_params(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")


def tp_inputs(cfg) -> dict:
    """Seeded inputs of a config's cells: prefill (TP_BATCH, TP_SEQ), decode
    one token a row at ``TP_INDEX`` over a random (TP_BATCH, TP_CACHE)
    cache, and one training microbatch with labels."""
    from repro_torch.models import transformer as PT

    g = torch.Generator().manual_seed(13)
    audio = cfg.frontend == "audio_codes"
    key = "codes" if audio else "tokens"

    def tok(*shape):
        shape = shape + ((cfg.n_codebooks,) if audio else ())
        return torch.randint(0, cfg.vocab, shape, generator=g, dtype=torch.int32)

    cache = PT.init_cache(cfg, TP_BATCH, TP_CACHE, device="cpu")
    for t in cache.values():
        t.normal_(generator=g)
    B = TP_BATCH
    return {"prefill": {key: tok(B, TP_SEQ)},
            "decode": ({key: tok(B, 1), "cur_index": torch.tensor(TP_INDEX, dtype=torch.int32)},
                       cache),
            "train": {key: tok(B, TP_SEQ), "labels": tok(B, TP_SEQ)}}


def tp_mesh(shape=TP_MESH):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=("replica", "data", "model"))


def _laid_out(module, prefix: str, mesh):
    """``module``'s parameters as DTensors by the reference's rules under
    their model names (``prefix`` + leaf), keyed by the module's own names."""
    from repro_torch.parallel import sharding as SH

    named = {prefix + k: p.detach() for k, p in module.named_parameters()}
    laid = SH.distribute(named, SH.params_sharding(named, mesh))
    return {k.removeprefix(prefix): v for k, v in laid.items()}


# (case, config, layer kind): each layer of the plan on the (1, 2) mesh
TP_LAYERS = [
    ("embed", "deepseek-7b", "embed"),
    ("embed codes", "musicgen-medium", "embed"),
    ("attention heads local", "deepseek-7b", "attn"),
    ("attention kv whole, MQA", "granite-34b", "attn"),
    ("attention kv whole, GQA", "stablelm-12b", "attn"),
    ("attention replicated", "musicgen-medium", "attn"),
    ("mlp gated", "deepseek-7b", "mlp"),
    ("mlp gelu", "musicgen-medium", "mlp"),
    ("mlp replicated", "granite-34b", "mlp"),
    ("parallel residual", "stablelm-12b", "block"),
    ("head", "deepseek-7b", "head"),
    ("head codebooks", "musicgen-medium", "head"),
    ("head replicated", "deepseek-7b/vocab-127", "head"),
    ("moe experts local", "granite-moe", "moe"),
    ("moe f local", "granite-moe/E3", "moe"),
    ("moe replicated", "granite-moe/E3-f129", "moe"),
    ("moe drops", "granite-moe/drops", "moe"),
    ("decode MQA, row on rank 0", "granite-34b", "decode"),
    ("decode MQA, row on rank 1", "granite-34b", "decode"),
    ("decode GQA, row on rank 0", "stablelm-12b", "decode"),
    ("decode GQA, row on rank 1", "stablelm-12b", "decode"),
    ("decode replicated attention", "musicgen-medium", "decode"),
    ("decode idle slot", "granite-34b", "decode"),
    ("decode int8 cache", "granite-34b/int8", "decode"),
    ("decode MLA absorbed, row on rank 0", "minicpm3", "mla decode"),
    ("decode MLA absorbed, row on rank 1", "minicpm3", "mla decode"),
]
# the decode cases' positions (B 2; the TP_CACHE rows split 8 | 8 over "model")
TP_DECODE_POSITIONS = {
    "decode MQA, row on rank 0": [[3], [5]],
    "decode MQA, row on rank 1": [[11], [14]],
    "decode GQA, row on rank 0": [[2], [7]],
    "decode GQA, row on rank 1": [[9], [15]],
    "decode replicated attention": [[4], [12]],
    "decode idle slot": [[-1], [12]],
    "decode int8 cache": [[6], [13]],
    "decode MLA absorbed, row on rank 0": [[1], [6]],
    "decode MLA absorbed, row on rank 1": [[10], [8]],
}


def tp_layer(kind: str, cfg, seed: int = 3):
    """A seeded float32 layer of ``kind`` with its model-name prefix."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as PT

    g = torch.Generator().manual_seed(seed)
    kw = dict(device="cpu", dtype=torch.float32)
    layer, prefix = {"embed": (L.Embed, "embed."), "attn": (L.Attention, "blocks.0.attn."),
                     "mlp": (L.MLP, "blocks.0.ff."), "head": (L.LMHead, "lm_head."),
                     "block": (PT.Block, "blocks.0."), "moe": (L.MoE, "blocks.0.ff."),
                     "decode": (L.Attention, "blocks.0.attn."),
                     "mla decode": (L.MLA, "blocks.0.attn.")}[kind]
    layer = layer(cfg, **kw)
    with torch.no_grad():
        for m in layer.modules():  # a block's norms, attention and FFN in order
            if hasattr(m, "init_weights"):
                m.init_weights(g)
    return layer, prefix


def tp_layer_cache(cfg) -> dict:
    """A seeded per-layer decode cache of (2, TP_CACHE) rows (random codes
    and scales for the int8 cache)."""
    from repro_torch.models import transformer as PT

    g = torch.Generator().manual_seed(7)
    cache = {k: v[0] for k, v in PT.init_cache(cfg, 2, TP_CACHE, device="cpu").items()}
    for k, t in cache.items():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8))
        elif k.endswith("_scale"):
            t.copy_(torch.rand(t.shape, generator=g) * 0.02 + 0.001)
        else:
            t.normal_(generator=g)
    return cache


def tp_layer_inputs(kind: str, cfg, seed: int = 4, case: str = "") -> dict:
    g = torch.Generator().manual_seed(seed)
    B, S = 2, TP_SEQ
    if kind in ("decode", "mla decode"):
        return {"x": torch.randn(B, 1, cfg.d_model, generator=g),
                "positions": torch.tensor(TP_DECODE_POSITIONS[case], dtype=torch.int32),
                "cache": tp_layer_cache(cfg)}
    if kind == "embed":
        shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
        return {"tokens": torch.randint(0, cfg.vocab, shape, generator=g)}
    x = torch.randn(B, S, cfg.d_model, generator=g)
    out = {"x": x, "positions": torch.arange(S, dtype=torch.int32).expand(B, S)}
    if kind == "head":
        shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
        out["labels"] = torch.randint(0, cfg.vocab, shape, generator=g)
    if kind == "moe":
        out["probe"] = torch.randn(B, S, cfg.d_model, generator=g)
    return out


def run_moe_layer(cfg, layer, inp: dict) -> dict:
    """The MoE's output, the gradients of sum(y * probe) with respect to x
    and every leaf (``d<leaf>``, on the leaf as the layer holds it), and the
    experts it picked (``picks``, from :meth:`MoE.select`)."""
    picks = []
    select = layer.select

    def recorded(probs, k):
        top = select(probs, k)
        picks.append(top)
        return top

    leaves = dict(layer.named_parameters())
    names = sorted(leaves)
    x = inp["x"].clone().requires_grad_(True)
    layer.select = recorded
    try:
        with torch.enable_grad():
            for n in names:
                leaves[n].requires_grad_(True)
            y = layer(cfg, x)
            grads = torch.autograd.grad(torch.sum(y * inp["probe"]), [x] + [leaves[n]
                                                                           for n in names])
    finally:
        del layer.select
        for n in names:
            leaves[n].requires_grad_(False)
    return {"y": y.detach(), "dx": grads[0], **{"d" + n: g for n, g in zip(names, grads[1:])},
            "picks": torch.cat(picks)}


def run_tp_layer(kind: str, cfg, layer, inp: dict) -> dict:
    """The layer's output (its logits, loss and the loss's gradients for
    the head; the gradients of x and every leaf for the MoE; the written
    cache for a decode step) where it runs: on the CPU meshless, or under
    the current tensor-parallel context on the shards
    :func:`tp_layer_cases` bound (a decode case's cache as given)."""
    from repro_torch.models import transformer as PT
    from repro_torch.parallel import tensor_parallel as TP

    if kind == "embed":
        return {"y": layer(inp["tokens"])}
    x = inp["x"]
    if kind == "moe":
        return run_moe_layer(cfg, layer, inp)
    if kind in ("decode", "mla decode"):
        cache = inp["cache"]
        with torch.no_grad():
            if kind == "decode":
                y = layer(cfg, x, inp["positions"], cache)
            else:
                y = layer(cfg, x, inp["positions"], cache, absorbed=True)
        return {"y": y, **{"cache " + k: t for k, t in cache.items()}}
    if kind == "attn":
        return {"y": layer(cfg, x, inp["positions"])}
    if kind == "mlp":
        return {"y": layer(x)}
    if kind == "block":
        return {"y": layer(cfg, x, inp["positions"])}
    x = x.clone().requires_grad_(True)
    w = layer.w
    with torch.enable_grad():
        w.requires_grad_(True)
        try:
            logits = layer(x)
            if TP.vocab_sharded(cfg):
                loss = TP.cross_entropy(logits, inp["labels"], cfg.n_codebooks, cfg.vocab_padded)
                whole = TP.gather_vocab(logits.detach(), cfg.n_codebooks, cfg.vocab_padded)
            else:
                loss = PT.cross_entropy(logits, inp["labels"])
                whole = logits.detach()
            dx, dw = torch.autograd.grad(loss, [x, w])
        finally:
            w.requires_grad_(False)
    return {"y": whole, "loss": loss.detach(), "dx": dx, "dw": dw}


def tp_layer_cases(mesh) -> tuple[dict, dict]:
    """Every :data:`TP_LAYERS` case on the (1, 2) mesh: the layer's
    parameters (and a decode case's cache) laid out by the reference's
    rules, the layer run on the rank's shards, its outputs gathered whole
    (each weight gradient and the written cache from their shards); and
    the shapes of the pieces each case's all-gathers moved."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel import tensor_parallel as TP

    from repro_torch.parallel import sharding as SH

    out, gathers = {}, {}
    for case, name, kind in TP_LAYERS:
        cfg = tp_config(name)
        layer, prefix = tp_layer(kind, cfg)
        laid = _laid_out(layer, prefix, mesh)
        TP.bind(layer, laid)
        inp = tp_layer_inputs(kind, cfg, case=case)
        cache = None
        if "cache" in inp:  # the cache laid out by the reference's rule, its shards given
            cache = SH.distribute(inp["cache"], SH.cache_sharding(cfg, inp["cache"], mesh, 2))
            inp["cache"] = {k: t.to_local() for k, t in cache.items()}
        collectives = tp_gathers()
        with TP.context(mesh, cache=cache):
            got = run_tp_layer(kind, cfg, layer, inp)
        gathers[case] = collectives.stop()
        for k in list(got):
            leaf = k[1:] if k.startswith("d") else k.removeprefix("cache ")
            if k != "dx" and k.startswith("d") and leaf in laid:  # a gradient on the leaf's shard
                got[k] = DTensor.from_local(got[k], mesh, laid[leaf].placements,
                                            run_check=False).full_tensor()
            elif cache is not None and k.startswith("cache "):
                got[k] = cache[leaf].full_tensor()
        out[case] = got
    return out, gathers


class tp_gathers:
    """The shapes of every rank's piece that ``tensor_parallel``'s
    all-gathers move in this process, from construction to :meth:`stop`."""

    def __init__(self):
        from repro_torch.parallel import tensor_parallel as TP

        self.shapes, self._orig = [], TP._pieces

        def pieces(t, group, n):
            self.shapes.append(tuple(t.shape))
            return self._orig(t, group, n)

        TP._pieces = pieces

    def stop(self) -> list:
        from repro_torch.parallel import tensor_parallel as TP

        TP._pieces = self._orig
        return self.shapes


def tp_cell_cases(mesh) -> dict:
    """Every :data:`TP_CONFIGS` config's cells on the (1, 2) mesh: prefill
    logits, decode logits with the cache row written, and one training
    microbatch's loss and gradients (the ZeRO accumulator, gathered)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import steps as ST
    from repro_torch.parallel import sharding as SH

    out = {}
    for name in TP_CONFIGS:
        cfg = tp_config(name)
        model = tp_model(cfg)
        params = dict(model.named_parameters())
        inputs = tp_inputs(cfg)
        res = {}
        step, _, (p_sh, b_sh) = ST.build_cell(
            cfg, ShapeSpec("prefill", "prefill", TP_SEQ, TP_BATCH), mesh)
        res["prefill"] = step(SH.distribute(params, p_sh), SH.distribute(inputs["prefill"], b_sh))
        step, _, (p_sh, b_sh, c_sh) = ST.build_cell(
            cfg, ShapeSpec("decode", "decode", TP_CACHE, TP_BATCH), mesh)
        inp, cache = inputs["decode"]
        cache = SH.distribute({k: v.clone() for k, v in cache.items()}, c_sh)
        p_d, i_d = SH.distribute(params, p_sh), SH.distribute(inp, b_sh)
        gathers = tp_gathers()
        logits, cache = step(p_d, i_d, cache)
        res["decode gathers"] = gathers.stop()
        res["decode cache"] = {k: tuple(v.to_local().shape[1:]) for k, v in cache.items()}
        res["decode"] = (logits, {k: v.full_tensor()[:, :, TP_INDEX] for k, v in cache.items()})
        _, _, (p_sh, o_sh, b_sh) = ST.build_cell(
            cfg, ShapeSpec("train", "train", TP_SEQ, TP_BATCH), mesh)
        batch = {k: v.to_local() for k, v in SH.distribute(inputs["train"], b_sh).items()}
        accum, loss = ST.zero_accumulated_grads(cfg, SH.distribute(params, p_sh), batch, 1,
                                                o_sh["mu"])
        res["train"] = (loss, {k: a.full_tensor() for k, a in accum.items()})
        out[name] = res
    return out


def tp_memory_case() -> dict:
    """The weights a rank holds while the cell model (fsdp: the embedding
    and the head also split over "data") takes a train step and a prefill
    step on the 2 x 2 mesh: every tensor the leaf gather makes, the most
    of their bytes live at once (storages tracked by ``weakref``
    finalizers, as ``parallel.op_analysis`` tracks live memory), and the
    step's own count of the largest layer's gathered leaves
    (``gathered_bytes``)."""
    import dataclasses

    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel import tensor_parallel as TP

    mesh = make_host_mesh(model_parallel=2, device="cpu")
    cfg, model = cell_model()
    cfg = dataclasses.replace(cfg, fsdp=True, fsdp_inference=True)
    params = dict(model.named_parameters())
    inputs, shapes = cell_inputs(cfg), cell_shapes()
    state = {"live": 0, "peak": 0, "made": []}
    orig = TP._leaf_forward

    def freed(n):
        state["live"] -= n

    def tracked(t, plan, ctx):
        full = orig(t, plan, ctx)
        if plan.gathers:
            storage = full.untyped_storage()
            state["live"] += storage.nbytes()
            state["peak"] = max(state["peak"], state["live"])
            state["made"].append(tuple(full.shape))
            weakref.finalize(storage, freed, storage.nbytes())
        return full

    out = {}
    TP._leaf_forward = tracked
    try:
        for kind in ("train", "prefill 2"):
            state.update(live=0, peak=0, made=[])
            step, args, sh = ST.build_cell(cfg, shapes[kind], mesh)
            p_d = SH.distribute(params, sh[0])
            if kind == "train":
                step(p_d, SH.distribute(adamw_init(params), sh[1]),
                     SH.distribute(inputs["train"], sh[2]))
            else:
                step(p_d, SH.distribute(inputs[kind], sh[1]))
            out[kind] = {"peak": state["peak"], "made": list(state["made"]),
                         "live after": state["live"],
                         "specs": {k: s.spec for k, s in sh[0].items()},
                         "largest layer": ST.gathered_bytes(cfg, shapes[kind].kind, args,
                                                            sh)["params"]}
    finally:
        TP._leaf_forward = orig
    return out


def tp_cases() -> dict:
    mesh = tp_mesh()
    layers, gathers = tp_layer_cases(mesh)
    one = tp_mesh(TP_MESH_ONE)
    return {"coordinate": tuple(mesh.get_coordinate()), "layers": layers,
            "layer gathers": gathers, "cells": tp_cell_cases(mesh), "memory": tp_memory_case(),
            "layers m1": tp_layer_cases(one)[0], "cells m1": tp_cell_cases(one)}


# --------------------------------------------------------------------------
# the spawn, once per test process
# --------------------------------------------------------------------------

JOIN_DEADLINE_S = 240
_RESULTS: list = []


def spawn_ranks(out) -> list:
    """The 4 ranks' results, in rank order, run once per process (the two
    test files that read them share one spawn where they share a
    process). ``out``: a temporary directory (``pathlib.Path``). A rank
    that raises or dies, or a join past the deadline, fails the calling
    test with the ranks' stderr."""
    import pytest
    import torch.multiprocessing as mp

    if _RESULTS:
        return _RESULTS[0]
    url = f"file://{out / 'rendezvous'}"
    ctx = mp.spawn(run_rank, args=(WORLD, url, str(out)), nprocs=WORLD, join=False)
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
        errs = "\n".join(f"--- rank {r} stderr:\n" + (out / f"rank{r}.err").read_text()[-3000:]
                         for r in range(WORLD) if (out / f"rank{r}.err").exists())
        pytest.fail(f"{failure}\n{errs}")
    results = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    _RESULTS.append(results)
    return results
