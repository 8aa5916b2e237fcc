"""The port's launch tooling against the reference's: ``configs.shapes``,
``effective_microbatches``, ``input_specs``, ``cache_specs``,
``launch.steps.abstract_state`` and ``build_cell``, ``launch.mesh`` and
``launch.dryrun.run_cell``.

* ``SHAPES``, ``applicable_shapes`` and ``effective_microbatches`` (DP 16
  and 32) equal the reference's for every config.
* ``input_specs`` and ``cache_specs`` (``meta`` tensors) equal the
  reference's ``ShapeDtypeStruct``s in shape and type, for every config x
  applicable shape; ``abstract_state`` equals the reference's through the
  convert mapping (``blocks.<i>.<path>`` is row i of ``blocks/<path>``).
* The production meshes, ``build_cell`` and the dry run need a 256- or
  512-rank world: one subprocess holds the ``fake`` backend and runs them
  all (``make_production_mesh``, its ``ValueError`` on a wrong world,
  ``make_host_mesh``, every cell's ``run_cell``; a second one beside it
  runs the multi-pod records); this process never initialises a process
  group. Each record carries the reference's count keys. Its per-device
  argument bytes equal the sum of ``NamedSharding.shard_shape`` bytes
  over the reference's leaves on the same ``AbstractMesh``, and what the
  port's step gathers beyond them is counted from the reference's leaves
  and specs by the step's own rules."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import applicable_shapes as ref_applicable
from repro.configs import cache_specs as ref_cache_specs
from repro.configs import effective_microbatches as ref_effective
from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.configs.shapes import LONG_CONTEXT_ARCHS as REF_LONG
from repro.launch.steps import abstract_state as ref_abstract_state
from repro.parallel import sharding as RS
from repro_torch.configs import SHAPES, applicable_shapes, cache_specs, effective_microbatches
from repro_torch.configs import get_config, input_specs
from repro_torch.configs.shapes import LONG_CONTEXT_ARCHS
from repro_torch.launch.steps import abstract_state
from repro_torch.parallel import sharding as PS
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CELLS = [(a, s) for a in ARCH_IDS for s in ref_applicable(a)]


def port_flat(tree, sep=".") -> dict:
    out = {}
    PS.tree_map_with_path(lambda p, x: out.__setitem__(p, x), tree, sep=sep)
    return out


def ref_flat(tree) -> dict:
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda p, x: out.__setitem__(RS._path_str(p), x), tree,
        is_leaf=lambda x: isinstance(x, NamedSharding))
    return out


def same_struct(t: torch.Tensor, s) -> bool:
    return t.device.type == "meta" and tuple(t.shape) == tuple(s.shape) \
        and str(t.dtype).removeprefix("torch.") == str(s.dtype)


def test_shapes_equal_the_reference():
    assert SHAPES == {k: type(SHAPES[k])(**vars(v)) for k, v in REF_SHAPES.items()}
    assert LONG_CONTEXT_ARCHS == REF_LONG
    for arch in ARCH_IDS:
        assert applicable_shapes(arch) == ref_applicable(arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_effective_microbatches_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name in SHAPES:
        for dp in (1, 16, 32):
            assert effective_microbatches(cfg, SHAPES[name], dp) == \
                ref_effective(rcfg, REF_SHAPES[name], dp), (name, dp)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_and_cache_specs_equal_the_reference(arch, shape):
    """Shapes and types of every input (DP 16 and 32) and every cache leaf."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for dp in (16, 32):
        got, want = input_specs(cfg, shape, dp_size=dp), ref_input_specs(rcfg, shape, dp_size=dp)
        assert got.keys() == want.keys()
        for k, s in want.items():
            assert same_struct(got[k], s), (dp, k, got[k], s)
    if SHAPES[shape].kind == "decode":
        got = port_flat(cache_specs(cfg, shape), sep="/")
        want = ref_flat(ref_cache_specs(rcfg, shape))
        assert got.keys() == want.keys()
        for k, s in want.items():
            assert same_struct(got[k], s), (k, got[k], s)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_state_equals_the_reference(arch):
    """Parameters and AdamW moments (``opt_moments_dtype``) and the step
    counter: every port leaf is its reference stack's row (same trailing
    shape, same type), and every reference leaf is covered."""
    params, opt = abstract_state(get_config(arch))
    rparams, ropt = ref_abstract_state(ref_get_config(arch))
    for tree, rtree in ((params, rparams), (opt, ropt)):
        leaves, rleaves = port_flat(tree), ref_flat(rtree)
        depths = PS.stack_depths(leaves)
        reached = set()
        for name, t in leaves.items():
            path, shape, _ = PS.reference_leaf(name, tuple(t.shape), depths)
            r = rleaves[path]
            assert t.device.type == "meta" and shape == tuple(r.shape), (name, shape, r.shape)
            assert str(t.dtype).removeprefix("torch.") == str(r.dtype), name
            reached.add(path)
        assert reached == set(rleaves)
    assert abstract_state(get_config(arch), with_opt=False).keys() == params.keys()


# --------------------------------------------------------------------------
# the fake backend: meshes, cells and the dry run, in one subprocess
# --------------------------------------------------------------------------

FAKE_RUN = r"""
import json, sys
import torch
import torch.distributed as dist
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun, mesh as M
from repro_torch.launch.steps import build_cell

out = {"meshes": {}, "errors": {}}
torch.set_num_threads(1)
with dryrun.fake_world(256):
    m = M.make_production_mesh(device="cpu")
    out["meshes"]["16x16"] = [list(m.shape), list(m.mesh_dim_names), m.size()]
    try:
        M.make_production_mesh(multi_pod=True, device="cpu")
    except ValueError as e:
        out["errors"]["multi_pod on 256"] = str(e)
    h = M.make_host_mesh(model_parallel=16, device="cpu")
    out["meshes"]["host"] = [list(h.shape), list(h.mesh_dim_names), h.size()]
    try:
        M.make_host_mesh(model_parallel=3, device="cpu")
    except ValueError as e:
        out["errors"]["model_parallel 3"] = str(e)
    cfg = get_config("deepseek-7b")
    step, args, shardings = build_cell(cfg, ShapeSpec("train_4k", "train", 4096, 256), m)
    out["train cell"] = {"n_args": len(args), "step": callable(step),
                         "tokens": list(args[2]["tokens"].shape),
                         "tokens spec": list(shardings[2]["tokens"].spec),
                         "wq placements": [repr(p) for p in shardings[0]["blocks.0.attn.wq"].placements],
                         "mu wq spec": [str(x) for x in shardings[1]["mu"]["blocks.0.attn.wq"].spec]}
with dryrun.fake_world(512):
    m = M.make_production_mesh(multi_pod=True, device="cpu")
    out["meshes"]["2x16x16"] = [list(m.shape), list(m.mesh_dim_names), m.size()]
out["group after"] = dist.is_initialized()
out["records"] = dryrun.run_cells(dryrun.all_cells(), [False], capacity_bytes=80 * 10**9)
json.dump(out, open(sys.argv[1], "w"))
"""

# the multi-pod records, in a second process beside the first
FAKE_RUN_MULTI_POD = r"""
import json, sys
import torch
from repro_torch.launch import dryrun

torch.set_num_threads(1)
records = dryrun.run_cells(dryrun.all_cells(), [True], capacity_bytes=80 * 10**9)
json.dump({"records": records}, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def fake_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [(subprocess.Popen([sys.executable, "-c", code, str(tmp / f"{i}.json")], cwd=ROOT,
                               env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                               text=True), tmp / f"{i}.json")
             for i, code in enumerate((FAKE_RUN, FAKE_RUN_MULTI_POD))]
    outs = []
    for proc, path in procs:
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
        outs.append(json.loads(path.read_text()))
    outs[0]["records"] += outs[1]["records"]
    return outs[0]


def test_production_meshes_under_the_fake_backend(fake_run):
    import torch.distributed as dist

    assert fake_run["meshes"] == {"16x16": [[16, 16], ["data", "model"], 256],
                                  "host": [[16, 16], ["data", "model"], 256],
                                  "2x16x16": [[2, 16, 16], ["pod", "data", "model"], 512]}
    assert "needs a world of 512 ranks" in fake_run["errors"]["multi_pod on 256"]
    assert "does not divide 256 ranks" in fake_run["errors"]["model_parallel 3"]
    assert fake_run["group after"] is False
    assert not dist.is_initialized()  # nothing in the pytest process


def test_build_cell_under_the_fake_backend(fake_run):
    """deepseek-7b's train_4k cell on 16 x 16: 8 microbatches of 32 rows
    (batch over "data"), wq heads over "model", its moment ZeRO-sharded."""
    cell = fake_run["train cell"]
    assert cell["n_args"] == 3 and cell["step"]
    assert cell["tokens"] == [8, 32, 4096] and cell["tokens spec"] == [None, "data", None]
    assert cell["wq placements"] == ["Replicate()", "Shard(dim=1)"]
    assert cell["mu wq spec"] == ["data", "model", "None"]


def test_the_dry_run_covers_every_cell(fake_run):
    """Every record carries the reference's keys (``flops_per_device``,
    ``bytes_per_device``, ``collectives``, ``collectives_weighted``,
    ``memory.temp_bytes``) beside the port's byte counts, and ``fits``
    holds ``step_bytes + temp_bytes`` against the capacity. Every cell
    runs the tensor-parallel plan: its all-gathers (the embedding's
    columns at least, and the leaves each layer gathers for its call)
    cover the largest layer's gathered leaves, which the step holds at
    its peak (``temp_bytes``). An attention-only config's decode gathers
    no cache entry (split-KV where its sequence is split), and a MoE
    config's cells sum the experts' partial combines (all-reduces)."""
    from repro_torch.parallel.op_analysis import COLLECTIVES

    recs = fake_run["records"]
    assert len(recs) == 2 * len(CELLS) == 64
    assert {(r["arch"], r["shape"], r["mesh"]) for r in recs} == \
        {(a, s, m) for a, s in CELLS for m in ("16x16", "2x16x16")}
    for r in recs:
        mem = r["memory"]
        assert mem["resident_bytes"] == mem["argument_bytes"] + mem["output_bytes"] \
            - mem["alias_bytes"]
        parts = [v for k, v in mem.items() if k.startswith("gathered_") and k != "gathered_bytes"]
        assert mem["gathered_bytes"] == sum(parts) and mem["gathered_params_bytes"] >= 0
        assert mem["step_bytes"] == mem["resident_bytes"] + mem["gathered_bytes"]
        assert mem["peak_estimate_bytes"] == mem["resident_bytes"] + mem["temp_bytes"]
        assert r["fits"] == (mem["step_bytes"] + mem["temp_bytes"] <= 80 * 10**9)
        assert r["n_devices"] == (512 if r["mesh"] == "2x16x16" else 256)
        assert r["params"] == get_config(r["arch"]).n_params
        assert r["flops_per_device"] == r["flops_products_per_device"] \
            + r["flops_other_per_device"]
        assert r["flops_products_per_device"] > r["flops_other_per_device"] > 0
        assert r["bytes_per_device"] > 0
        coll, w = r["collectives"], r["collectives_weighted"]
        assert set(coll) == {"bytes", "counts", "total_bytes"}
        assert set(w) == {"bytes", "counts", "wire_bytes", "total_bytes", "total_wire_bytes"}
        assert set(coll["bytes"]) <= set(COLLECTIVES) and "all-gather" in coll["bytes"]
        assert w["bytes"] == coll["bytes"] and w["counts"] == coll["counts"]
        assert coll["total_bytes"] == w["total_bytes"] == sum(coll["bytes"].values())
        assert w["total_wire_bytes"] == sum(w["wire_bytes"].values())
        assert coll["bytes"]["all-gather"] >= mem["gathered_params_bytes"]
        assert mem["temp_bytes"] >= mem["gathered_params_bytes"], (r["arch"], r["shape"])
        if r["shape"] == "train_4k":
            assert coll["counts"]["all-reduce"] > 0
        cfg = get_config(r["arch"])
        if cfg.block_pattern is None and r["shape"] in ("decode_32k", "long_500k"):
            # every attention cache entry is read where it is stored: split
            # by its DP batch shard, its kv heads or its sequence (split-KV)
            assert mem["gathered_cache_bytes"] == 0, (r["arch"], r["shape"], r["mesh"])
        if cfg.is_moe:  # the combine's float32 partials summed over "model"
            assert coll["counts"]["all-reduce"] > 0, (r["arch"], r["shape"])


def ref_bytes(tree, shardings) -> int:
    """Sum of the reference's per-device shard bytes."""
    leaves, specs = ref_flat(tree), ref_flat(shardings)
    return sum(int(np.prod(specs[k].shard_shape(v.shape))) * np.dtype(v.dtype).itemsize
               for k, v in leaves.items())


def whole_bytes(x) -> int:
    return int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize


def axes_of(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def kept_model_dim(rcfg, path: str, m: int):
    """The dim (from the end) that the tensor-parallel plan keeps on
    "model" for the reference leaf at ``path``, or None: the embedding's d
    where m divides it, the head's vocab where m divides Vp, attention's
    q heads and ``wo`` rows where m divides H (its k/v heads where it
    divides Hkv too), the MLP's f where m divides it, the MoE's experts
    where m divides E (else each expert's f where m divides it); MLA, the
    router and the mixers keep none."""
    leaf = path.rsplit("/", 1)[-1]
    if path == "embed/table":
        return -1 if rcfg.d_model % m == 0 else None
    if path == "lm_head/w":
        return -1 if rcfg.vocab_padded % m == 0 else None
    if "/attn/" in path and not rcfg.use_mla and rcfg.n_heads % m == 0:
        if leaf in ("wq", "wo") or (leaf in ("wk", "wv") and rcfg.n_kv_heads % m == 0):
            return -2
    if "/ff/" in path and rcfg.is_moe and rcfg.n_experts % m == 0:
        return {"w_in": -3, "w_gate": -3, "w_out": -3}.get(leaf)
    if "/ff/" in path and rcfg.d_ff % m == 0:
        return {"w_in": -1, "w_gate": -1, "w_out": -2}.get(leaf)
    return None


def held(nbytes: int, spec: tuple, sizes: dict, kept: set) -> int:
    """Bytes of a tensor of ``nbytes`` laid out by ``spec`` with only the
    (axis, dim) pairs of ``kept`` still split, where any other axis is
    gathered; else 0 (used as stored)."""
    split = gathered = 1
    for d, e in enumerate(spec):
        for a in axes_of(e):
            if (a, d) in kept:
                split *= sizes[a]
            else:
                gathered *= sizes[a]
    return nbytes // split if gathered > 1 else 0


def ref_gathered(rcfg, kind, rparams, p_shard, ropt=None, o_shard=None, rin=None,
                 in_shard=None, rcache=None, c_shard=None, mesh_sizes=None) -> dict:
    """What the port's step holds beyond its arguments per device, counted
    on the reference's leaves and specs by the tensor-parallel plan: the
    largest layer's gathered leaves (per layer of a stack: its share; a
    leaf gathers every axis but the "model" dim its layer keeps,
    :func:`kept_model_dim`); a train step's gradients on their shards
    (the parameters' shard bytes) and its accumulator shards (the
    moments' shard shapes in ``grad_accum_dtype``); a decode step's
    largest layer of cache entries, each keeping its DP batch shard where
    the inputs' batch dim names a DP axis, its heads where the attention
    computes on local kv heads and its sequence split where every
    attention entry of the layer has its sequence split alike (split-KV
    decode, MLA's absorbed decode among it, on m > 1), every other split
    dim gathered."""
    dp = {"pod", "data"}
    m = mesh_sizes["model"]
    leaves, specs = ref_flat(rparams), ref_flat(p_shard)
    scopes: dict = {}
    for k, v in leaves.items():
        spec = tuple(specs[k].spec) + (None,) * (len(v.shape) - len(specs[k].spec))
        keep = kept_model_dim(rcfg, k, m)
        kept = {("model", keep % len(v.shape))} if keep is not None else set()
        stacked = k.startswith("blocks/") and not k.startswith("blocks/attn_shared/")
        per = held(whole_bytes(v), spec, mesh_sizes, kept) // (v.shape[0] if stacked else 1)
        owner = k.rsplit("/", 1)[0]
        scopes[owner] = scopes.get(owner, 0) + per
    out = {"params": max(scopes.values(), default=0)}
    if kind == "train":
        mu, mu_specs = ref_flat(ropt["mu"]), ref_flat(o_shard["mu"])
        item = np.dtype(rcfg.grad_accum_dtype).itemsize
        out["grads"] = ref_bytes(rparams, p_shard)
        out["accum"] = sum(int(np.prod(mu_specs[k].shard_shape(v.shape))) * item
                           for k, v in mu.items())
    elif kind == "decode":
        main = next(k for k in ("tokens", "codes", "embeds") if k in rin)
        by_batch = any(set(axes_of(e)) & dp for e in in_shard[main].spec)
        heads_local = not rcfg.use_mla and rcfg.n_heads % m == 0 and rcfg.n_kv_heads % m == 0
        homogeneous = all(k == "attn" for k in rcfg.pattern) and not rcfg.shared_attn
        lead = 1 if homogeneous else 0
        split_kv = m > 1 and (not rcfg.use_mla or rcfg.mla_absorbed_decode)
        layers, c_specs = {}, ref_flat(c_shard)
        for k, v in ref_flat(rcache).items():
            spec = tuple(c_specs[k].spec) + (None,) * (len(v.shape) - len(c_specs[k].spec))
            layers.setdefault("" if homogeneous else k.split("/")[0], []).append((k, v, spec))
        per_layer = {}
        for layer, items in layers.items():
            names = {k.rsplit("/", 1)[-1] for k, _, _ in items}
            seqs = {tuple(a for a in axes_of(spec[lead + 1]) if mesh_sizes[a] > 1)
                    for _, _, spec in items}
            attention = names <= {"k", "v", "k_scale", "v_scale", "c_kv", "k_rope"}
            seq = seqs.pop() if split_kv and attention and len(seqs) == 1 else ()
            for k, v, spec in items:
                kept = {(a, lead) for a in dp} if by_batch else set()
                if heads_local and k.rsplit("/", 1)[-1] in ("k", "v"):
                    kept.add(("model", lead + 2))
                kept |= {(a, lead + 1) for a in seq}
                size = held(whole_bytes(v), spec, mesh_sizes, kept)
                per_layer[layer] = per_layer.get(layer, 0) + (size // v.shape[0] if homogeneous
                                                              else size)
        out["cache"] = max(per_layer.values(), default=0)
    return out


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_cell_bytes_equal_the_reference_shard_shapes(fake_run, arch, mesh):
    """Parameters, moments, inputs and cache bytes per device, cell by
    cell, against the reference's leaves laid out by its own rules on an
    ``AbstractMesh``; the output and alias bytes by the donation; and
    what the port's step gathers, counted on the reference's leaves and
    specs (:func:`ref_gathered`)."""
    multi = mesh == "2x16x16"
    amesh = AbstractMesh((2, 16, 16) if multi else (16, 16),
                         ("pod", "data", "model") if multi else ("data", "model"))
    dp = 32 if multi else 16
    rcfg = ref_get_config(arch)
    rparams, ropt = ref_abstract_state(rcfg)
    for r in fake_run["records"]:
        if r["arch"] != arch or r["mesh"] != mesh:
            continue
        shape = REF_SHAPES[r["shape"]]
        mem = r["memory"]
        rin = ref_input_specs(rcfg, shape, dp_size=dp)
        assert mem["inputs_bytes"] == ref_bytes(rin, RS.input_sharding(rcfg, amesh, rin))
        fsdp = rcfg.fsdp if shape.kind == "train" else rcfg.fsdp_inference
        p_shard = RS.params_sharding(rparams, amesh, fsdp)
        assert mem["params_bytes"] == ref_bytes(rparams, p_shard)
        logits = shape.global_batch * max(1, rcfg.n_codebooks) * rcfg.vocab_padded * 4
        if shape.kind == "train":
            o_shard = RS.params_sharding(ropt, amesh, True)
            assert mem["moments_bytes"] == ref_bytes(ropt, o_shard)
            assert mem["alias_bytes"] == mem["params_bytes"] + mem["moments_bytes"]
            assert mem["output_bytes"] == mem["alias_bytes"] + 12
            gathered = ref_gathered(rcfg, "train", rparams, p_shard, ropt, o_shard,
                                    mesh_sizes=dict(amesh.shape))
        elif shape.kind == "decode":
            rcache = ref_cache_specs(rcfg, shape)
            c_shard = RS.cache_sharding(rcfg, rcache, amesh, shape.global_batch)
            want = ref_bytes(rcache, c_shard)
            assert mem["cache_bytes"] == want == mem["alias_bytes"]
            assert mem["output_bytes"] == logits + want
            gathered = ref_gathered(rcfg, "decode", rparams, p_shard, rin=rin,
                                    in_shard=RS.input_sharding(rcfg, amesh, rin), rcache=rcache,
                                    c_shard=c_shard, mesh_sizes=dict(amesh.shape))
        else:
            assert mem["alias_bytes"] == 0 and mem["output_bytes"] == logits
            gathered = ref_gathered(rcfg, "prefill", rparams, p_shard,
                                    mesh_sizes=dict(amesh.shape))
        assert {k: mem[f"gathered_{k}_bytes"] for k in gathered} == gathered, r["shape"]
