"""Dry run: lay out every (arch x shape x mesh) cell on the production mesh.

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
  5. adds what the port's step gathers beyond its arguments
     (``launch.steps.gathered_bytes``: every sharded weight whole, a
     train step's whole gradients and its accumulator shards, a decode
     step's cache relaid out to its DP shard), and holds that sum
     (``step_bytes``) against a capacity given as a parameter,
  6. writes ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
     when asked.

The reference also records XLA's ``temp_bytes``, ``flops_per_device``,
``bytes_per_device`` and the collectives parsed from the optimized HLO
(``repro.parallel.hlo_analysis``): its compiler derives them from the
partitioned program without running it. The port compiles no program and
runs eagerly, so it has no counterpart for them and the record leaves
them out. ``resident_bytes`` (arguments + outputs - aliases) is what the
reference's donation keeps; ``step_bytes`` adds what the port's step
gathers, and is still a lower bound of its peak: the activations and
other temporaries are not counted. The port gathers every weight whole,
so a cell that the reference's layout fits may not fit the port's step.

Usage:
  python -m repro_torch.launch.dryrun --all [--multi-pod|--both]
  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
"""

from __future__ import annotations

import argparse
import json
import time
from contextlib import contextmanager
from pathlib import Path

from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

__all__ = ["argument_bytes", "fake_world", "run_cell", "run_cells"]


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


def _logits_bytes(cfg, batch: int, seq: int) -> int:
    """float32 logits (B, S, [n_codebooks,] Vp), replicated."""
    return batch * seq * max(1, cfg.n_codebooks) * cfg.vocab_padded * 4


def run_cell(arch: str, shape_name: str, multi_pod: bool, save: bool = False,
             capacity_bytes: int | None = None) -> dict:
    """One cell's record. Needs the default process group to be the fake
    backend with 256 (``multi_pod`` False) or 512 ranks (:func:`fake_world`).
    ``capacity_bytes``: a device's memory, for the ``fits`` verdict
    (``None``: no verdict)."""
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
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_devices": mesh.size(),
        "build_s": round(time.perf_counter() - t0, 2),
        "memory": {
            **{f"{k}_bytes": v for k, v in parts.items()},
            "argument_bytes": argument,
            "output_bytes": output,
            "alias_bytes": alias,
            "resident_bytes": resident,
            **{f"gathered_{k}_bytes": v for k, v in gathered.items()},
            "gathered_bytes": sum(gathered.values()),
            "step_bytes": step_bytes,
        },
        "capacity_bytes": capacity_bytes,
        "fits": None if capacity_bytes is None else step_bytes <= capacity_bytes,
        "params": cfg.n_params,
    }
    if save:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        path = OUT_DIR / f"{arch}__{shape_name}__{mesh_name}.json"
        path.write_text(json.dumps(record, indent=1))
    verdict = "" if record["fits"] is None else ("fits" if record["fits"] else "OVER")
    print(f"[dryrun] {arch:22s} {shape_name:12s} {mesh_name:7s} "
          f"build {record['build_s']:5.2f}s  args/dev {argument / 1e9:7.3f} GB  "
          f"resident/dev {resident / 1e9:7.3f} GB  step/dev {step_bytes / 1e9:8.3f} GB "
          f"{verdict}", flush=True)
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
                    help="a device's memory in GB (1e9 B), for the fits verdict "
                         "(step_bytes: the arguments, outputs and what the step gathers)")
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
