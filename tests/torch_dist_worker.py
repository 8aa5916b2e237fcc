"""The body of one rank of ``tests/test_torch_distributed.py`` (imported by
the spawned processes; not collected). It imports torch, numpy and
``repro_torch`` only, runs every distributed case on the CPU with the
``gloo`` backend, and pickles its results to ``<out_dir>/rank<r>.pkl``."""

import os
import pickle

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


# the 2 x 2 ("data", "model") cells: a reduced deepseek-7b wide enough that
# the ZeRO rule (leaves of >= 2^22 bytes at 4 bytes an element) shards the
# embedding, the head and the stacked MLP weights' moments over "data"
CELL_MESH = {"data": 2, "model": 2}
CELL_SEQ, CELL_CACHE, CELL_INDEX = 8, 16, 6


def cell_model():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as PT

    cfg = get_config("deepseek-7b").reduced(n_layers=4, d_model=256, d_ff=1024, vocab=4096,
                                            train_microbatches=2)
    return cfg, PT.init_params(cfg, generator=torch.Generator().manual_seed(5), device="cpu")


def cell_inputs(cfg) -> dict:
    """Seeded inputs of the cells: prefill at batch 1 (not DP-sharded) and
    2, decode at batch 2 over a random cache, train as 2 microbatches of 2."""
    from repro_torch.models import transformer as PT

    g = torch.Generator().manual_seed(6)
    tok = lambda *shape: torch.randint(0, cfg.vocab, shape, generator=g, dtype=torch.int32)  # noqa: E731
    cache = PT.init_cache(cfg, 2, CELL_CACHE, device="cpu")
    for t in cache.values():
        t.normal_(generator=g)
    return {"prefill 1": {"tokens": tok(1, CELL_SEQ)},
            "prefill 2": {"tokens": tok(2, CELL_SEQ)},
            "decode": ({"tokens": tok(2, 1), "cur_index": torch.tensor(CELL_INDEX, dtype=torch.int32)},
                       cache),
            "train": {"tokens": tok(2, 2, CELL_SEQ), "labels": tok(2, 2, CELL_SEQ)}}


def cell_shapes():
    from repro_torch.configs import ShapeSpec

    return {"prefill 1": ShapeSpec("prefill", "prefill", CELL_SEQ, 1),
            "prefill 2": ShapeSpec("prefill", "prefill", CELL_SEQ, 2),
            "decode": ShapeSpec("decode", "decode", CELL_CACHE, 2),
            "train": ShapeSpec("train", "train", CELL_SEQ, 4)}


def cell_cases() -> dict:
    """The cells on a 2 x 2 mesh of the 4 ranks, every argument laid out by
    its sharding: gathered prefill and decode logits, the cache row the
    decode wrote, this rank's ZeRO accumulator shards (two microbatches),
    and the parameters, moments and metrics after one train step, each
    gathered whole."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import sharding as SH

    mesh = make_host_mesh(model_parallel=2, device="cpu")
    cfg, model = cell_model()
    inputs, shapes = cell_inputs(cfg), cell_shapes()
    params = dict(model.named_parameters())
    out = {"coordinate": tuple(mesh.get_coordinate())}
    for name in ("prefill 1", "prefill 2"):
        step, _, (p_sh, b_sh) = ST.build_cell(cfg, shapes[name], mesh)
        out[name] = step(SH.distribute(params, p_sh), SH.distribute(inputs[name], b_sh))
    step, _, (p_sh, b_sh, c_sh) = ST.build_cell(cfg, shapes["decode"], mesh)
    inp, cache = inputs["decode"]
    cache = SH.distribute(cache, c_sh)
    logits, cache = step(SH.distribute(params, p_sh), SH.distribute(inp, b_sh), cache)
    out["decode"] = (logits, {k: v.full_tensor()[:, :, CELL_INDEX] for k, v in cache.items()})
    step, _, (p_sh, o_sh, b_sh) = ST.build_cell(cfg, shapes["train"], mesh)
    batch = SH.distribute(inputs["train"], b_sh)
    local = {k: v.to_local() for k, v in batch.items()}
    accum, loss = ST.zero_accumulated_grads(cfg, model, local, 2, o_sh["mu"])
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
    results["cells"] = cell_cases()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()
