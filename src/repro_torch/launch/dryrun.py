"""Dry run: lay out every (arch x shape x mesh) cell on the production mesh
and count what one step of it does.

The port's counterpart of ``repro.launch.dryrun``. For each cell the dry
run, in a process that holds the ``fake`` process-group backend (one
process stands for every rank of a 256- or 512-rank world; no data
moves):

  1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod,
     ``launch.mesh.make_production_mesh(device="cpu")``),
  2. assembles the cell (``launch.steps.build_cell``): the step, its
     ``meta`` arguments and their shardings,
  3. lays every argument out as a DTensor and sums the local shards'
     bytes: parameters, moments, inputs and cache per device,
  4. adds the output bytes and the bytes the outputs alias in donated
     inputs, as the reference's donation defines them (a train step's
     parameters and moments; a decode step's cache: the port's steps
     update those in place),
  5. adds what the port's step holds beyond its arguments
     (``launch.steps.gathered_bytes``: the largest layer's gathered
     leaves, a train step's gradients on their local shards and its
     accumulator shards, a decode step's largest layer of cache entries
     as the layer computes on them): ``step_bytes``,
  6. counts one step (:func:`cell_counts`, ``parallel.op_analysis``): the
     step runs on ``meta`` tensors under the op counter, which gives the
     reference's ``flops_per_device``, ``bytes_per_device``,
     ``collectives``, ``collectives_weighted`` and ``memory.temp_bytes``,
  7. holds ``step_bytes + temp_bytes`` against a capacity given as a
     parameter (``fits``), and writes
     ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json`` when asked.

``resident_bytes`` (arguments + outputs - aliases) is what the
reference's donation keeps; ``step_bytes`` adds what the port's step
gathers, a lower bound of its peak; ``temp_bytes`` is the peak of what
the step holds beyond its arguments and outputs (the gathered tensors
among it, with the activations and every other temporary), so the
``fits`` verdict counts the gathered tensors twice: a margin, not a
peak. The port's step runs the reference's tensor-parallel plan
(``parallel.tensor_parallel``): heads, FFN hidden, experts and vocab split
over "model", decode over a sequence-split cache on the rank's rows, each
layer's other leaves gathered for its own call, so its
flops, collectives and memory are a rank's share of the plan XLA
partitions from the same specs, not of the whole model.

The counts are the port's, not XLA's: the counter adds up the eager ops
the step runs, where XLA counts its program after fusing elementwise
chains, leaving transcendentals out of ``flops`` and counting a while
body once (``parallel.op_analysis`` says how each figure is counted).
The serving cells (prefill, decode) are counted as the port serves on
the card, with attention on the flash kernel (``use_flash_kernel``:
4·D flops per kept pair); training runs the chunked core, as the kernel
has no backward.

A training step of a production cell runs millions of eager ops, so
:func:`cell_counts` counts such a step (and any past 100,000 ops, or with
an sLSTM layer) on shallower copies of the cell and extends their
counts over what the copies repeat: a layer of each block kind (the
blocks of a kind are alike), each microbatch (alike but for the first),
and, for an sLSTM layer (a Python loop over the positions), the
positions. The flops, bytes and collectives so extended equal a whole
count (``tests/test_torch_op_analysis.py`` holds them equal on every
config at small sizes); ``temp_bytes`` is extended over the layers and
positions too, from the copies' peaks at the same microbatch count (2
where there are more): an estimate. The serving cells count their step
whole but for MLA's prefill (chunked attention, with thousands of blocks
a layer) and the sLSTM's.

Usage:
  python -m repro_torch.launch.dryrun --all [--multi-pod|--both]
  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from contextlib import contextmanager
from fractions import Fraction
from pathlib import Path

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeSpec, applicable_shapes,
                                 effective_microbatches, get_config)

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

__all__ = ["argument_bytes", "cell_counts", "collective_bytes", "count_cell", "fake_world",
           "run_cell", "run_cells"]


@contextmanager
def fake_world(world_size: int):
    """The ``fake`` backend as the default process group of ``world_size``
    ranks, this process rank 0, for the duration of the block."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: this process already holds a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def argument_bytes(tree, shardings) -> int:
    """Bytes of this rank's shards of ``tree`` laid out by ``shardings``."""
    from repro_torch.parallel.sharding import distribute, tree_map

    sizes = []
    tree_map(lambda d: sizes.append(d.to_local().numel() * d.to_local().element_size()),
             distribute(tree, shardings))
    return sum(sizes)


def collective_bytes(trace) -> dict:
    """Per-kind output bytes and counts of every collective in a step's
    trace (``op_analysis.OpTrace``) and their total: the reference's
    ``collective_bytes`` over the port's trace."""
    from repro_torch.parallel.op_analysis import weighted_collective_bytes

    w = weighted_collective_bytes(trace)
    return {"bytes": w["bytes"], "counts": w["counts"], "total_bytes": w["total_bytes"]}


def count_cell(cfg, shape: ShapeSpec, mesh):
    """One step of the (``cfg``, ``shape``) cell on ``mesh`` counted on
    ``meta`` tensors (``op_analysis.count_step``): the ``OpTrace``. A
    decode step reads its cache cursor on the host; it is the last row."""
    import torch

    from repro_torch.launch.steps import build_cell
    from repro_torch.parallel.op_analysis import count_step
    from repro_torch.parallel.sharding import distribute

    step, args, shardings = build_cell(cfg, shape, mesh)
    args = tuple(distribute(a, s) for a, s in zip(args, shardings))
    values = {}
    if shape.kind == "decode":
        values[args[1]["cur_index"]._local_tensor] = torch.tensor(shape.seq_len - 1,
                                                               dtype=torch.int32)
    return count_step(step, *args, values=values)[1]


def _flat(trace) -> dict:
    """A trace's figures as one flat mapping, for sums of traces."""
    from repro_torch.parallel.op_analysis import COLLECTIVES, _wire_factor

    w = collective_bytes(trace)
    out = {"flops_products": trace.flops_products, "flops_other": trace.flops_other,
           "bytes": trace.bytes_accessed, "temp": trace.temp_bytes,
           **{f"{part}/{kind}": n for part in ("bytes", "counts") for kind, n in w[part].items()}}
    for kind, nbytes, group in trace.collectives:  # wire bytes kept exact until the end
        factor = Fraction(_wire_factor(kind, group)) if kind in COLLECTIVES else 1
        out[f"wire/{kind}"] = out.get(f"wire/{kind}", 0) + nbytes * factor
    return out


def _sum(*terms) -> dict:
    """Sum of ``(coefficient, flat counts)`` terms, key by key."""
    out: dict = {}
    for c, counts in terms:
        for k, v in counts.items():
            out[k] = out.get(k, 0) + c * v
    return out


#: block kinds whose layer loops over the positions in Python, and the
#: smallest of the three position counts their layer is counted at
_POSITION_LOOPS = ("slstm",)
_POSITION_PROBE = 64  # and its multiples 128 and 192
#: a step that would count more ops than this is counted on shallower copies
_WHOLE_MAX = 100_000


def _lagrange(xs, i: int, x) -> Fraction:
    """The weight of the value at ``xs[i]`` in the polynomial through
    ``xs`` evaluated at ``x``."""
    w = Fraction(1)
    for j, xj in enumerate(xs):
        if j != i:
            w *= Fraction(x - xj, xs[i] - xj)
    return w


def cell_counts(cfg, shape: ShapeSpec, mesh) -> dict:
    """The flat counts of one step of a production cell (:func:`count_cell`
    with the serving cells on the flash kernel). A step that would count
    more than :data:`_WHOLE_MAX` ops (its base copy's ops times its depth
    and microbatches), or that holds a kind of :data:`_POSITION_LOOPS`, is
    counted by :func:`_extended_counts`; any other is counted whole."""
    return _extended_counts(cfg, shape, mesh, whole_max=_WHOLE_MAX)


def _extended_counts(cfg, shape: ShapeSpec, mesh, whole_max: int = 0) -> dict:
    """The counts of one step from shallower copies of the cell, extended
    (the module docstring); with ``whole_max``, :func:`cell_counts`'s rule
    first (a step under it counted whole):

    * depth: the base stack B holds the first layer of each block kind (a
      homogeneous stack: one remat group, ``remat_group`` layers where it
      divides the depth); each kind k adds (n_k - b_k) / (layers per step)
      times the count of one more of its layers (B + k minus B);
    * microbatches (train, N > 1): the same at 1 and 2 microbatches of the
      cell's own size, extended by N - 1 times the second's increment;
      ``temp`` from the copies at 2;
    * ``temp`` of training is extended over the layers as the counts are
      (each layer's saved tensors stay to the backward); a serving step
      keeps nothing of a layer past its call, so its ``temp`` is the
      largest of the copies' (the base and one more layer of each kind),
      plus what the position-loop layers add;
    * positions: a kind of :data:`_POSITION_LOOPS` is left out of B, and
      one layer of it (on the first layer of B) is counted at 64, 128 and
      192 positions and interpolated at S by the parabola through the
      three: its forward is affine in S (the projections, one cell per
      position), and its backward adds a term in S² (each position's
      gradient is scattered into a zero tensor of all S positions). A peak
      is no polynomial in S: such a layer adds to ``temp`` what it adds
      at 64 positions (what the step keeps of it from its call to the
      end, such as its gradients)."""
    from repro_torch.launch.steps import _dp_size

    train = shape.kind == "train"
    N = effective_microbatches(cfg, shape, _dp_size(mesh)) if train else 1
    rows = shape.global_batch // N
    flash = dataclasses.replace(cfg, use_flash_kernel=not train)
    kinds = list(dict.fromkeys(cfg.pattern))
    loops = [k for k in kinds if k in _POSITION_LOOPS] if shape.seq_len > 1 else []
    base = [k for k in kinds if k not in loops]
    if not base:
        raise ValueError(f"{cfg.name}: every block kind loops over positions")
    unit = 1
    if cfg.block_pattern is None and cfg.remat and cfg.n_layers % cfg.remat_group == 0:
        unit = cfg.remat_group
    base = base * unit
    traced: dict = {}

    def probe(pattern, m, seq):
        key = (tuple(pattern), m, seq)
        if key not in traced:
            c = dataclasses.replace(flash, n_layers=len(pattern), train_microbatches=m,
                                    block_pattern=tuple(pattern) if cfg.block_pattern else None)
            s = ShapeSpec(shape.name, shape.kind, seq, m * rows if train else shape.global_batch)
            traced[key] = count_cell(c, s, mesh)
        return traced[key]

    if not loops and probe(base, 1, shape.seq_len).n_ops * N * cfg.n_layers // len(base) \
            <= whole_max:
        return {k: int(v) for k, v in _flat(count_cell(flash, shape, mesh)).items()}

    def at(m):
        b = _flat(probe(base, m, shape.seq_len))
        terms, peaks, loop_temp = [(1, b)], [b["temp"]], 0
        for k in kinds:
            if k in loops:
                # one layer of k at three position counts, interpolated at S
                xs = [_POSITION_PROBE * (i + 1) for i in range(3)]
                ds = [_sum((1, _flat(probe(base[:1] + [k], m, x))),
                           (-1, _flat(probe(base[:1], m, x)))) for x in xs]
                per_layer = _sum(*[(_lagrange(xs, i, shape.seq_len), d)
                                   for i, d in enumerate(ds)])
                # a peak is no polynomial in S: the layer adds to the peak what
                # it adds at the shortest count
                per_layer["temp"] = ds[0]["temp"]
                terms.append((cfg.pattern.count(k), per_layer))
                loop_temp += cfg.pattern.count(k) * per_layer["temp"]
            else:
                deeper = _flat(probe(base + [k] * unit, m, shape.seq_len))
                peaks.append(deeper["temp"])
                terms.append((Fraction(cfg.pattern.count(k) - base.count(k), unit),
                              _sum((1, deeper), (-1, b))))
        out = _sum(*terms)
        if not train:
            # serving keeps no layer's tensors past its call (one layer's
            # gathered leaves and activations at a time): more layers of a
            # kind leave the peak where one more of them puts it
            out["temp"] = max(peaks) + loop_temp
        return out

    one = at(1)
    if N == 1:
        counts = one
    else:
        two = at(2)
        counts = _sum((1, one), (N - 1, _sum((1, two), (-1, one))))
        counts["temp"] = two["temp"]
    return {k: int(round(v)) for k, v in counts.items()}


def _logits_bytes(cfg, batch: int, seq: int) -> int:
    """float32 logits (B, S, [n_codebooks,] Vp), replicated."""
    return batch * seq * max(1, cfg.n_codebooks) * cfg.vocab_padded * 4


def run_cell(arch: str, shape_name: str, multi_pod: bool, save: bool = False,
             capacity_bytes: int | None = None) -> dict:
    """One cell's record. Needs the default process group to be the fake
    backend with 256 (``multi_pod`` False) or 512 ranks (:func:`fake_world`).
    ``capacity_bytes``: a device's memory, for the ``fits`` verdict on
    ``step_bytes + temp_bytes`` (``None``: no verdict)."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell, gathered_bytes

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    _, args, shardings = build_cell(cfg, shape, mesh)
    parts = dict(zip({"train": ("params", "moments", "inputs"),
                      "prefill": ("params", "inputs"),
                      "decode": ("params", "inputs", "cache")}[shape.kind],
                     (argument_bytes(a, s) for a, s in zip(args, shardings))))
    if shape.kind == "train":
        # (params, opt_state, {"loss", "grad_norm", "lr"}): the first two
        # alias the donated inputs, the metrics are three float32 scalars
        alias = parts["params"] + parts["moments"]
        output = alias + 3 * 4
    elif shape.kind == "prefill":
        output, alias = _logits_bytes(cfg, shape.global_batch, 1), 0
    else:
        alias = parts["cache"]
        output = _logits_bytes(cfg, shape.global_batch, 1) + alias
    argument = sum(parts.values())
    resident = argument + output - alias
    gathered = gathered_bytes(cfg, shape.kind, args, shardings)
    step_bytes = resident + sum(gathered.values())
    t1 = time.perf_counter()
    counts = cell_counts(cfg, shape, mesh)
    coll = {part: {k.split("/", 1)[1]: v for k, v in counts.items() if k.startswith(part + "/")}
            for part in ("bytes", "counts", "wire")}
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_devices": mesh.size(),
        "build_s": round(t1 - t0, 2),
        "count_s": round(time.perf_counter() - t1, 2),
        "flops_per_device": counts["flops_products"] + counts["flops_other"],
        "flops_products_per_device": counts["flops_products"],
        "flops_other_per_device": counts["flops_other"],
        "bytes_per_device": counts["bytes"],
        "collectives": {"bytes": coll["bytes"], "counts": coll["counts"],
                        "total_bytes": sum(coll["bytes"].values())},
        "collectives_weighted": {"bytes": coll["bytes"], "counts": coll["counts"],
                                 "wire_bytes": coll["wire"],
                                 "total_bytes": sum(coll["bytes"].values()),
                                 "total_wire_bytes": sum(coll["wire"].values())},
        "memory": {
            **{f"{k}_bytes": v for k, v in parts.items()},
            "argument_bytes": argument,
            "output_bytes": output,
            "alias_bytes": alias,
            "resident_bytes": resident,
            **{f"gathered_{k}_bytes": v for k, v in gathered.items()},
            "gathered_bytes": sum(gathered.values()),
            "step_bytes": step_bytes,
            "temp_bytes": counts["temp"],
            "peak_estimate_bytes": resident + counts["temp"],
        },
        "capacity_bytes": capacity_bytes,
        "fits": None if capacity_bytes is None else step_bytes + counts["temp"] <= capacity_bytes,
        "params": cfg.n_params,
    }
    if save:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        path = OUT_DIR / f"{arch}__{shape_name}__{mesh_name}.json"
        path.write_text(json.dumps(record, indent=1))
    verdict = "" if record["fits"] is None else ("fits" if record["fits"] else "OVER")
    print(f"[dryrun] {arch:22s} {shape_name:12s} {mesh_name:7s} "
          f"build {record['build_s']:5.2f}s count {record['count_s']:6.2f}s  "
          f"args/dev {argument / 1e9:7.3f} GB  resident/dev {resident / 1e9:7.3f} GB  "
          f"step + temp/dev {(step_bytes + counts['temp']) / 1e9:8.3f} GB {verdict}  "
          f"flops/dev {record['flops_per_device']:.3e}  "
          f"coll {record['collectives']['total_bytes'] / 1e6:8.1f} MB", flush=True)
    return record


def run_cells(cells, meshes, save: bool = False, capacity_bytes: int | None = None
              ) -> list[dict]:
    """Every (arch, shape) of ``cells`` on every mesh of ``meshes`` (``False``
    single-pod, ``True`` multi-pod), each mesh in its own fake world."""
    out = []
    for multi_pod in meshes:
        with fake_world(512 if multi_pod else 256):
            out += [run_cell(arch, shape, multi_pod, save, capacity_bytes)
                    for arch, shape in cells]
    return out


def all_cells() -> list[tuple[str, str]]:
    return [(arch, shape) for arch in ARCH_IDS for shape in applicable_shapes(arch)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true", help="run 16x16 and 2x16x16")
    ap.add_argument("--capacity-gb", type=float, default=None,
                    help="a device's memory in GB (1e9 B), for the fits verdict on step_bytes "
                         "(the arguments, outputs and what the step gathers) + temp_bytes")
    args = ap.parse_args(argv)
    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both else [args.multi_pod]
    capacity = None if args.capacity_gb is None else int(args.capacity_gb * 1e9)
    records = run_cells(cells, meshes, save=True, capacity_bytes=capacity)
    print(f"[dryrun] all {len(records)} cells laid out; records in {OUT_DIR}")


if __name__ == "__main__":
    main()
