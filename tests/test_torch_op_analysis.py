"""The port's op counter (``repro_torch.parallel.op_analysis``) and the dry
run's counts (``launch.dryrun.cell_counts``), the counterpart of the
reference's ``parallel/hlo_analysis.py`` and of the XLA figures of its dry
run.

* (a) Products: the counter's product flops on a reduced deepseek-7b
  prefill step equal the analytic count, and a run on CPU data counts
  what a trace on ``meta`` tensors counts.
* (b) Collectives: on a 2 x 2 ``fake`` mesh, a cell's collectives equal
  those its code issues, counted by hand from the tensor-parallel plan
  (``launch/steps.py``, ``parallel/tensor_parallel.py``), the split-KV
  decode at batch 1 among them.
* (c) Wire factors: ``weighted_collective_bytes`` applies the reference's
  ``_wire_factor`` to each kind and group size.
* (d) Reference: on one CPU device, the port's ``flops_per_device`` of a
  reduced train cell lies within a band, stated before the run, of XLA's
  ``cost_analysis`` flops of the reference's cell; on a (1, 2) mesh of two
  host devices (a subprocess with ``--xla_force_host_platform_device_count=2``)
  the per-device flops of the same cell lie within the same band of the
  port's count on a 2-rank ``fake`` world, and XLA's partitioned program
  issues the same kinds of collectives over "model" as the port's plan;
  so do reduced granite-moe's train cell (the experts over "model", the
  combine an all-reduce, no all-to-all) and reduced granite-34b's decode
  cell (split-KV: no all-gather of the cache).
* (e) Fake tensors: each kernel op's wrapper gives a ``meta`` or
  ``FakeTensorMode`` tensor the kernel's output shape and type, launches
  nothing and never runs the plain version; the counter counts the op
  whole.
* The dry run's extension (shallower copies, extended over the depth,
  the microbatches and the sLSTM's positions) equals a whole count of
  the same step, config by config.

The process-group parts run in ONE subprocess that holds the ``fake``
backend; this process never initialises a process group."""

import json
import math
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs.shapes import ShapeSpec as RefShapeSpec
from repro.parallel import hlo_analysis as RH
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.quant_matmul import kernel as QK
from repro_torch.kernels.quant_matmul import ops as QO
from repro_torch.kernels.ssm_scan import kernel as SK
from repro_torch.kernels.ssm_scan import ops as SO
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import transformer as T
from repro_torch.parallel import op_analysis as OA
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

# (d): the reduced deepseek-7b train cell both packages count, one layer and
# one microbatch of 2 x 64 tokens, so that XLA's loops (the layer scan, the
# attention chunk loops: q_chunk and kv_chunk are the whole sequence) each
# run once and its count is the whole step's
REF_CELL = dict(n_layers=1, q_chunk=64, kv_chunk=64)
REF_SEQ, REF_BATCH = 64, 2
# The band, derived before the run. Both sides count the same products:
# the same projections, MLP and head, the chunked attention's one block
# of every (q, k) pair, each forward product twice more in the backward
# (2·M·N·K each, XLA's dot as torch's mm). The rest is elementwise work,
# reductions and AdamW: by the estimate below (per token some 2,600 flops
# of norms, RoPE, SiLU, residuals and the head's mask against 114,688 of
# products, 6 per attention score against 64, three times for the
# backward, and about 20 per parameter for AdamW) about 5% of the total.
# XLA leaves transcendentals out and counts casts; the port counts every
# eager op. So the two may differ by at most that whole share either
# way; the band doubles it for the estimate's own error.
REF_BAND = 0.10


# --------------------------------------------------------------------------
# the fake backend: collectives, the extension and the 1 x 1 cell
# --------------------------------------------------------------------------

FAKE_RUN = r"""
import json, sys
from dataclasses import replace
import torch
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, applicable_shapes, get_config
from repro_torch.launch import dryrun, mesh as M
from repro_torch.launch.steps import build_cell
from repro_torch.parallel.sharding import tree_map

torch.set_num_threads(1)
out = {"cells": {}, "extension": {}}


with dryrun.fake_world(4):
    mesh = M.make_host_mesh(model_parallel=2, device="cpu")
    cfg = get_config("deepseek-7b").reduced(fsdp=True, train_microbatches=2)
    for name, shape in (("train", ShapeSpec("train_4k", "train", 64, 8)),
                        ("prefill", ShapeSpec("prefill_32k", "prefill", 64, 4))):
        c = replace(cfg, use_flash_kernel=name != "train")
        trace = dryrun.count_cell(c, shape, mesh)
        _, args, sh = build_cell(c, shape, mesh)
        leaves = {}
        tree_map(lambda t, s: leaves.__setitem__(len(leaves), (list(t.shape), t.element_size(),
                 [repr(p) for p in s.placements], str(t.dtype))), args[0], sh[0])
        moments = {}
        if name == "train":
            tree_map(lambda t, s: moments.__setitem__(len(moments), [repr(p) for p in s.placements]),
                     args[1]["mu"], sh[1]["mu"])
        out["cells"][name] = {"collectives": trace.collectives, "params": leaves,
                              "moments": moments, "rows": shape.global_batch // 2,
                              "vocab_padded": c.vocab_padded,
                              "micro": 2 if name == "train" else 1,
                              "seq": shape.seq_len, "d_model": c.d_model,
                              "n_layers": c.n_layers, "dtype_bytes": 4}
    # batch 1 divides no DP width: the cache's sequence is split over "data"
    shape = ShapeSpec("decode_32k", "decode", 64, 1)
    trace = dryrun.count_cell(cfg, shape, mesh)
    _, args, sh = build_cell(cfg, shape, mesh)
    out["decode"] = {"collectives": trace.collectives, "vocab_padded": cfg.vocab_padded,
                     "d_model": cfg.d_model, "n_layers": cfg.n_layers, "heads": cfg.n_heads,
                     "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                     "cache": {k: [str(e) for e in s.spec] for k, s in sh[2].items()}}
    for arch in ARCH_IDS:
        full = get_config(arch)
        if full.block_pattern is None:
            cfg = full.reduced(train_microbatches=4, remat=True, n_layers=4)
        else:
            pattern = tuple((list(dict.fromkeys(full.pattern)) * 3)[:5])
            cfg = replace(full.reduced(train_microbatches=4, remat=True), n_layers=5,
                          block_pattern=pattern)
        for name in applicable_shapes(arch):
            kind = SHAPES[name].kind
            shape = ShapeSpec(name, kind, {"train": 64, "prefill": 128}.get(kind, 256), 16)
            got = dryrun._extended_counts(cfg, shape, mesh)
            whole = dryrun._flat(dryrun.count_cell(replace(cfg, use_flash_kernel=kind != "train"),
                                                   shape, mesh))
            out["extension"][f"{arch}/{name}"] = {
                "extended": got, "whole": {k: int(v) for k, v in whole.items()},
                "by_default": dryrun.cell_counts(cfg, shape, mesh)}
with dryrun.fake_world(1):
    mesh = M.make_host_mesh(device="cpu")
    cfg = get_config("deepseek-7b").reduced(n_layers=1, q_chunk=64, kv_chunk=64)
    counts = dryrun.cell_counts(cfg, ShapeSpec("train_4k", "train", 64, 2), mesh)
    out["one_device_train"] = counts
with dryrun.fake_world(2):
    mesh = M.make_host_mesh(model_parallel=2, device="cpu")
    cfg = get_config("deepseek-7b").reduced(n_layers=1, q_chunk=64, kv_chunk=64)
    out["two_device_train"] = dryrun.cell_counts(cfg, ShapeSpec("train_4k", "train", 64, 2), mesh)
    cfg = get_config("granite-moe-1b-a400m").reduced(n_layers=1, q_chunk=64, kv_chunk=64)
    out["two_device_moe_train"] = dryrun.cell_counts(cfg, ShapeSpec("train_4k", "train", 64, 2),
                                                     mesh)
    cfg = get_config("granite-34b").reduced(n_layers=1)
    shape = ShapeSpec("decode_32k", "decode", DECODE_SEQ, 2)
    trace = dryrun.count_cell(replace(cfg, use_flash_kernel=True), shape, mesh)
    out["two_device_mqa_decode"] = {**{k: int(v) for k, v in dryrun._flat(trace).items()},
                                    "collectives": trace.collectives,
                                    "entry_bytes": 2 * DECODE_SEQ * cfg.n_kv_heads
                                    * cfg.head_dim * 4}
json.dump(out, open(sys.argv[1], "w"))
""".replace("DECODE_SEQ", "256")

# (d) on two host devices: the reference's one-layer train cell lowered on a
# (1, 2) ("data", "model") mesh, its per-device flops and the collectives of
# its optimized HLO
XLA_RUN = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.configs.shapes import ShapeSpec
from repro.launch.steps import build_cell
from repro.parallel import hlo_analysis as RH

arch, kind, seq, batch = sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5])
over = dict(n_layers=1) if kind == "decode" else dict(n_layers=1, q_chunk=64, kv_chunk=64)
cfg = get_config(arch).reduced(**over)
mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
with mesh:
    fn, args = build_cell(cfg, ShapeSpec(kind + "_cell", kind, seq, batch), mesh)
    compiled = fn.lower(*args).compile()
cost = compiled.cost_analysis()
cost = cost[0] if isinstance(cost, list) else cost
w = RH.weighted_collective_bytes(compiled.as_text())
json.dump({"flops": float(cost["flops"]), "counts": w["counts"]}, open(sys.argv[1], "w"))
"""


def xla_two_devices(tmp_path, arch: str, kind: str, seq: int, batch: int) -> dict:
    """XLA's per-device flops and collective counts of the reference's
    one-layer ``kind`` cell of ``arch`` on a (1, 2) mesh of two host devices."""
    path = tmp_path / "xla.json"
    proc = subprocess.run([sys.executable, "-c", XLA_RUN, str(path), arch, kind, str(seq),
                           str(batch)], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                               "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
                               "JAX_PLATFORMS": "cpu"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(path.read_text())


def kinds(port: dict) -> set:
    return {k.split("/", 1)[1] for k, v in port.items() if k.startswith("counts/") and v}


@pytest.fixture(scope="module")
def fake_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("op_analysis") / "out.json"
    proc = subprocess.run([sys.executable, "-c", FAKE_RUN, str(path)], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(path.read_text())


# --------------------------------------------------------------------------
# (a) products
# --------------------------------------------------------------------------


def meta_model(cfg):
    return T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu").to("meta")


def prefill_products(cfg, B: int, S: int) -> int:
    """2·M·N·K per linear (q, k, v, o, the gated MLP's three, the head over
    the padded vocab), 4·D per kept (q, k) pair of the causal attention."""
    d, H, Hkv, Dh, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    tokens = B * S
    layer = 2 * tokens * (d * H * Dh + 2 * d * Hkv * Dh + H * Dh * d + 3 * d * F)
    attention = 4 * Dh * B * H * S * (S + 1) // 2
    head = 2 * tokens * d * cfg.vocab_padded
    return cfg.n_layers * (layer + attention) + head


def test_a_prefill_products_equal_the_analytic_count():
    cfg = replace(get_config("deepseek-7b").reduced(), use_flash_kernel=True)
    assert cfg.n_layers == 2 and not cfg.is_moe and cfg.gated_mlp
    B, S = 2, 48
    tokens = torch.zeros((B, S), dtype=torch.int32, device="meta")
    logits, trace = OA.count_step(make_prefill_step(cfg), meta_model(cfg), {"tokens": tokens})
    assert logits.shape == (B, cfg.vocab_padded) and logits.device.type == "meta"
    assert trace.kernels == {"flash_attention": cfg.n_layers}
    assert trace.flops_products == prefill_products(cfg, B, S)
    assert 0 < trace.flops_other < trace.flops_products
    assert trace.collectives == []


def test_a_cpu_data_counts_what_the_meta_trace_counts():
    """Chunked attention with the causal skip (no flash kernel) reads the
    last position of each q chunk on the host: the meta trace takes it
    from the value the counter carries beside the positions, and counts
    what the run on data counts (flops, bytes, live memory). The kv rows
    are padded to 96, three chunks of 32, and the skip keeps, for the five
    q chunks of 16 rows, 32, 32, 64, 64 and 96 of them: 4·D flops per
    (q, kv row) pair of those blocks, the masked pairs included."""
    cfg = get_config("deepseek-7b").reduced()
    B, S = 2, 80
    tokens = torch.zeros((B, S), dtype=torch.int32)
    step = make_prefill_step(cfg)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    _, real = OA.count_step(step, model, {"tokens": tokens})
    _, meta = OA.count_step(step, model.to("meta"), {"tokens": tokens.to("meta")})
    assert real.kernels == meta.kernels == {}
    for field in ("flops_products", "flops_other", "bytes_accessed", "temp_bytes",
                  "peak_bytes", "n_ops"):
        assert getattr(real, field) == getattr(meta, field), field
    assert (cfg.q_chunk, cfg.kv_chunk) == (16, 32)
    kept = sum(min(3, (16 * qi + 15 + 32) // 32) * 32 for qi in range(S // 16))
    assert kept == 32 + 32 + 64 + 64 + 96
    attention = 4 * cfg.head_dim * B * cfg.n_heads * 16 * kept
    flash = 4 * cfg.head_dim * B * cfg.n_heads * S * (S + 1) // 2
    assert real.flops_products == prefill_products(cfg, B, S) + cfg.n_layers * (attention - flash)


def test_a_a_read_without_a_value_raises():
    def step(x):
        return int(x.sum())

    with pytest.raises(RuntimeError, match="carries no value"):
        OA.count_step(step, torch.zeros(3, device="meta"))
    t = torch.zeros(3, device="meta", dtype=torch.int32)
    assert OA.count_step(step, t, values={t: torch.tensor([1, 2, 3])})[0] == 6
    assert OA.count_step(lambda: int(torch.arange(4, device="meta").sum()))[0] == 6


# --------------------------------------------------------------------------
# (b) collectives
# --------------------------------------------------------------------------


def shard_dims(placements) -> list[int]:
    return [i for i, p in enumerate(placements) if p.startswith("Shard")]


def test_b_collectives_equal_what_the_steps_issue(fake_run):
    """Counted by hand from the tensor-parallel plan (``launch/steps.py``,
    ``parallel/tensor_parallel.py``) on the 2 x 2 ("data", "model") mesh,
    every group of 2 ranks; x is a rank's (rows, S, d) activation in
    float32:

    * every weight is used as stored: the heads, the FFN hidden, the vocab
      and the embedding's d split over "model" (m = 2 divides them all),
      no leaf large enough for FSDP; so no weight is gathered;
    * the forward: the embedding's columns gathered over "model" (one
      all-gather of x's bytes); per block two float32 all-reduces of x over
      "model" (attention's ``wo`` and the FFN's out, row-parallel);
    * prefill: the last position's logits gathered over "model" ((rows,
      Vp) float32), then over "data" (``_gather_rows``: (B, Vp));
    * train, per microbatch: the loss's max, sum of exponentials and gold
      logit reduced over "model" (three all-reduces of (rows, S) float32);
      the backward's all-reduce of x's float32 gradient at each
      column-parallel input (the head's, and per block attention's and the
      FFN's); each gradient, on its local shard in float32, summed over
      "data" in rank order: one all-gather of the two ranks' shards (no
      moment is ZeRO-split at this size); then the loss (one float32
      scalar, over "data") and the gradient norm (a scalar per leaf and
      per mesh dim its accumulator shards). The weights keep their
      moments' layout, so storing them back moves nothing."""
    for name, cell in fake_run["cells"].items():
        rows = cell["rows"] // cell["micro"]
        x = rows * cell["seq"] * cell["d_model"] * 4
        # no weight split over "data"
        assert all(p[0] == "Replicate()" for _, _, p, _ in cell["params"].values())
        forward = [("all-gather", x, 2)] + [("all-reduce", x, 2)] * (2 * cell["n_layers"])
        if name == "prefill":
            want = forward + [("all-gather", rows * cell["vocab_padded"] * 4, 2),
                              ("all-gather", 2 * rows * cell["vocab_padded"] * 4, 2)]
        else:
            loss = [("all-reduce", rows * cell["seq"] * 4, 2)] * 3
            backward = [("all-reduce", x, 2)] * (1 + 2 * cell["n_layers"])
            grads = [("all-gather", 2 * math.prod(shape) // (2 if shard_dims(pl) else 1) * 4, 2)
                     for shape, _, pl, _ in cell["params"].values()]
            want = (forward + loss + backward + grads) * cell["micro"] + [("all-reduce", 4, 2)]
            want += [("all-reduce", 4, 2) for placements in cell["moments"].values()
                     for _ in shard_dims(placements)]
            assert [p for _, _, p, _ in cell["params"].values()] == \
                list(cell["moments"].values())
        got = [tuple(c) for c in cell["collectives"]]
        assert sorted(got) == sorted(want), name
        assert {k for k, _, _ in got} <= set(OA.COLLECTIVES)


def test_b_split_kv_decode_collectives_equal_what_the_step_issues(fake_run):
    """The decode cell at batch 1 on the 2 x 2 mesh, counted by hand: the
    batch divides no DP width, so the cache's sequence is split over
    "data" and its kv heads over "model"; each rank writes and attends on
    its own rows and heads. x is the (1, 1, d) float32 activation:

    * the embedding's columns gathered over "model" (x's bytes);
    * per block, over "data": the row max and the sum of exponentials of
      the rank's H / 2 heads (float32 (1, 1, H / 2)) and their float32 P·V
      partials ((1, 1, H / 2, Dh)); over "model": attention's ``wo`` and the
      FFN's out (x each);
    * the logits gathered over "model" ((1, Vp) float32); the batch is not
      DP-split, so nothing is gathered over "data".

    No cache entry is gathered."""
    cell = fake_run["decode"]
    assert cell["cache"]["k"] == ["None", "None", "data", "model", "None"]
    x = cell["d_model"] * 4
    local = cell["heads"] // 2 * 4
    block = [("all-reduce", local, 2)] * 2 + [("all-reduce", local * cell["head_dim"], 2),
                                              ("all-reduce", x, 2), ("all-reduce", x, 2)]
    want = ([("all-gather", x, 2)] + block * cell["n_layers"]
            + [("all-gather", cell["vocab_padded"] * 4, 2)])
    assert sorted(tuple(c) for c in cell["collectives"]) == sorted(want)


# --------------------------------------------------------------------------
# (c) wire factors
# --------------------------------------------------------------------------


@pytest.mark.parametrize("group", [1, 2, 16, 256])
@pytest.mark.parametrize("kind", RH.COLLECTIVES)
def test_c_wire_factors_are_the_references(kind, group):
    assert OA.COLLECTIVES == RH.COLLECTIVES
    assert OA._wire_factor(kind, group) == RH._wire_factor(kind, group)
    trace = OA.OpTrace(collectives=[(kind, 4096, group), (kind, 1000, group)])
    w = OA.weighted_collective_bytes(trace)
    assert w["bytes"] == {kind: 5096} and w["counts"] == {kind: 2}
    assert w["wire_bytes"] == {kind: int(4096 * RH._wire_factor(kind, group)
                                         + 1000 * RH._wire_factor(kind, group))}
    assert w["total_bytes"] == 5096 and w["total_wire_bytes"] == w["wire_bytes"][kind]


# --------------------------------------------------------------------------
# (d) the reference's XLA count
# --------------------------------------------------------------------------


def test_d_flops_lie_within_the_band_of_xlas(fake_run):
    from jax.sharding import Mesh

    from repro.launch.steps import build_cell as ref_build_cell

    rcfg = ref_get_config("deepseek-7b").reduced(**REF_CELL)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with mesh:
        fn, args = ref_build_cell(rcfg, RefShapeSpec("train_4k", "train", REF_SEQ, REF_BATCH),
                                  mesh)
        cost = fn.lower(*args).compile().cost_analysis()
    xla = float((cost[0] if isinstance(cost, list) else cost)["flops"])
    port = fake_run["one_device_train"]
    flops = port["flops_products"] + port["flops_other"]
    assert abs(flops / xla - 1) <= REF_BAND, (flops, xla, port["flops_products"])


def test_d_two_devices_the_plan_is_xlas(fake_run, tmp_path):
    """The same cell on a (1, 2) mesh: XLA's per-device ``cost_analysis``
    flops of the reference's partitioned program against the port's count
    of its tensor-parallel step on a 2-rank ``fake`` world, within
    ``REF_BAND`` (its derivation holds per device: both split the same
    products two ways), and the kinds of collectives XLA's optimized HLO
    issues over "model" (the only axis of more than one device) against
    the kinds the port's plan issues."""
    xla = xla_two_devices(tmp_path, "deepseek-7b", "train", REF_SEQ, REF_BATCH)
    port = fake_run["two_device_train"]
    flops = port["flops_products"] + port["flops_other"]
    assert abs(flops / xla["flops"] - 1) <= REF_BAND, (flops, xla["flops"])
    assert kinds(port) == {k for k, v in xla["counts"].items() if v}, (kinds(port), xla["counts"])


def test_d_two_devices_the_moe_plan_is_xlas(fake_run, tmp_path):
    """Reduced granite-moe's one-layer train cell (4 experts, top 2) on the
    (1, 2) mesh: XLA partitions the reference's dispatch and combine with
    the experts on "model" and the combine einsum as a float32 all-reduce
    over "model", never an all-to-all, as the port's expert-parallel plan
    does (every rank routes the same tokens and runs its 2 experts). The
    per-device flops lie within ``REF_BAND`` (its derivation holds: the
    reference's one-hot dispatch and combine einsums are products the port
    replaces by index gathers, a few percent of this cell's flops, inside
    the band's doubled share), and the kinds of collectives are equal."""
    xla = xla_two_devices(tmp_path, "granite-moe-1b-a400m", "train", REF_SEQ, REF_BATCH)
    port = fake_run["two_device_moe_train"]
    flops = port["flops_products"] + port["flops_other"]
    assert abs(flops / xla["flops"] - 1) <= REF_BAND, (flops, xla["flops"])
    assert not xla["counts"].get("all-to-all") and not port.get("counts/all-to-all")
    assert kinds(port) == {k for k, v in xla["counts"].items() if v}, (kinds(port), xla["counts"])


def test_d_two_devices_the_split_kv_decode_is_xlas(fake_run, tmp_path):
    """Reduced granite-34b's one-layer decode cell (4 q heads on one kv
    head: the cache's sequence split over "model") at batch 2 on the (1, 2)
    mesh: XLA gathers q over the heads and all-reduces the scores' row max,
    the sums of exponentials and the float32 P·V partials, and never
    gathers the cache; the port issues the same kinds of collectives, and
    none of its all-gathers is as large as one layer's cache entry."""
    port = fake_run["two_device_mqa_decode"]
    seq = port["entry_bytes"] // (2 * 16 * 4)
    xla = xla_two_devices(tmp_path, "granite-34b", "decode", seq, 2)
    assert kinds(port) == {k for k, v in xla["counts"].items() if v}, (kinds(port), xla["counts"])
    gathers = [b for kind, b, _ in port["collectives"] if kind == "all-gather"]
    assert gathers and max(gathers) < port["entry_bytes"], (gathers, port["entry_bytes"])
    maxima = [b for kind, b, _ in port["collectives"] if kind == "all-reduce" and b == 2 * 4 * 4]
    assert len(maxima) == 2  # the row max and the sum of exponentials, (2, 1, 1, 4) float32


# --------------------------------------------------------------------------
# (e) the kernel ops on tensors that hold no data
# --------------------------------------------------------------------------


def no_plain(monkeypatch):
    for module, name in ((FA, "attention_ref"), (QO, "quant_matmul_plain"),
                         (QO, "w8a16_matmul_plain"), (SO, "ssm_scan_plain")):
        monkeypatch.setattr(module, name, lambda *a, **kw: pytest.fail("plain version ran"))


def kernel_calls():
    """Every kernel op's wrapper on fresh tensors (made in the caller's
    mode and device): (name, output, expected shape, expected type)."""
    B, S, H, D = 2, 32, 4, 16
    q = torch.zeros((B, S, H, D), dtype=torch.bfloat16)
    kv = torch.zeros((B, S, 2, D), dtype=torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32)
    a_q, w_q = torch.zeros((15, 64), dtype=torch.int8), torch.zeros((64, 24), dtype=torch.int8)
    x, w_scale = torch.zeros((15, 64), dtype=torch.bfloat16), torch.ones(24)
    xs, bc, a = torch.zeros((B, S, 3, 8)), torch.zeros((B, S, 4)), torch.zeros((B, S, 3))
    return [
        ("flash_attention", FA.flash_attention(q, kv, kv, q_positions=pos, kv_positions=pos,
                                               scale=0.25), (B, S, H, D), torch.bfloat16),
        ("quant_matmul", QO.quant_matmul(a_q, w_q, 0.5, 3, w_scale), (15, 24), torch.float32),
        ("w8a16_matmul", QO.w8a16_matmul(x, w_q, w_scale, out_dtype=torch.bfloat16), (15, 24),
         torch.bfloat16),
        ("ssm_scan", SO.ssm_scan(xs, bc, bc, a, a, chunk=16), (B, S, 3, 8), torch.float32),
    ]


def test_e_fake_tensors_take_no_kernel_and_no_plain_version(monkeypatch):
    no_plain(monkeypatch)
    FA.reset_launch_count()
    QK.reset_launch_counts()
    SK.reset_launch_count()
    with FakeTensorMode():
        calls = kernel_calls()
    for name, out, shape, dtype in calls:
        assert kernels.holds_no_data(out) and tuple(out.shape) == shape, name
        assert out.dtype == dtype, name
    assert (FA.FLASH_LAUNCHES, QK.W8A8_LAUNCHES, QK.W8A16_LAUNCHES, SK.SSD_LAUNCHES) == (0,) * 4


def test_e_meta_tensors_are_counted_as_their_kernel_ops(monkeypatch):
    no_plain(monkeypatch)
    with torch.device("meta"):
        counter = OA.OpCounter()
        with counter:
            calls = kernel_calls()
        trace = counter.close()
    assert trace.kernels == {name: 1 for name, *_ in calls}
    for name, out, shape, dtype in calls:
        assert out.device.type == "meta" and tuple(out.shape) == shape and out.dtype == dtype
    # the flash op's 4·D per kept pair (8 heads of 32 rows: S(S+1)/2 pairs
    # each) and the two GEMMs' 2·M·N·K among the products
    assert trace.flops_products >= 4 * 16 * 8 * 32 * 33 // 2 + 2 * (2 * 15 * 24 * 64)
    assert OA.KERNEL_FLOPS["flash_attention"](torch.empty(8, 32, 16), torch.empty(4, 32, 16),
                                              None, None, None) == 4 * 16 * 8 * 32 * 33 // 2
    assert OA.KERNEL_FLOPS["quant_matmul"](torch.empty(15, 64), torch.empty(64, 24)) == \
        2 * 15 * 64 * 24


# --------------------------------------------------------------------------
# the dry run's extension against a whole count
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_extension_equals_a_whole_count(fake_run, arch):
    """Flops, bytes and every collective's bytes, counts and wire bytes of
    the extended count equal the whole count of the same step (4 layers,
    or 5 of a block pattern; 4 microbatches; 64 positions for training,
    128 for prefill, a 256-row cache for decode; 2 x 2 mesh); the memory
    peak (``temp``) is the estimate the module docstring describes, and
    within a quarter of the whole count's. By default ``cell_counts``
    gives one of the two."""
    cells = {k: v for k, v in fake_run["extension"].items() if k.startswith(arch + "/")}
    assert cells
    for name, c in cells.items():
        got, whole = c["extended"], c["whole"]
        assert {k for k in got if k != "temp"} == {k for k in whole if k != "temp"}, name
        for k, v in whole.items():
            if k != "temp":
                assert got[k] == v, (name, k)
        assert abs(got["temp"] - whole["temp"]) <= whole["temp"] / 4, name
        assert c["by_default"] in (whole, got), name
