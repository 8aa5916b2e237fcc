"""Sharded scenario-axis solves: one stacked tensor, every card.

The port's counterpart of ``repro.core.shard``. The scenario axis of the
exact split DP is embarrassingly parallel (scenario ``s``'s recurrence
never reads scenario ``t``), so a fleet-scale ``C[S, N, L, L]`` splits
into equal shards, one per device, each solved by the SAME dense DP the
single-device backends run:

* :func:`sharded_dp_tables` pads ``S`` to a multiple of the shard count
  with replicas of the last scenario (and of its ``ns`` entry), solves
  each shard on its device and drops the padding rows before anything
  reads them. ``kernel="cuda"`` runs :func:`repro_torch.core.cuda_dp.dense_dp`
  on each shard (the dense CUDA kernel on a card, its plain version on
  the CPU, by the wrapper's rule); ``kernel="torch"`` runs
  :func:`~repro_torch.core.cuda_dp.dense_dp_plain`. Each scenario's
  arithmetic is untouched, so the tables are node-identical to
  ``backend="cuda"`` (or ``"torch"``) by construction.
* :func:`sharded_optimal_dp` is the :class:`~repro_torch.core.sweep.
  BatchedSolverResult` entry behind ``batched_optimal_dp(backend="sharded")``
  (per-scenario ``n_devices``, ``return_all_k``, the shared timing scope).

Shards are a list of torch devices (:func:`mesh_from_spec`):

* no spec, or ``MeshSpec(kind="local")``: the first ``n_shards`` cards of
  this process (``None``: every card). With ``device="cpu"`` the shards
  are simulated in one process, the counterpart of XLA's forced host
  device count: any ``n_shards >= 1``, and ``None`` means 1.
* ``MeshSpec(kind="distributed")``: the ``torch.distributed`` seam, one
  shard per rank of the default process group. ``coordinator=None``
  asserts that the caller initialised the group; otherwise the group is
  initialised here once per process with the ``gloo`` backend
  (``coordinator`` is ``host:port`` for a TCP rendezvous, or a URL such
  as ``file:///path``). Rank ``r`` solves its shard on
  ``cuda:{r % device_count}`` (or the CPU), and the host tables are
  ``all_gather``ed, so every rank returns the whole result. Gloo, because
  the tables come back to the host anyway and because ranks that share
  one card cannot join one NCCL communicator.

Bottleneck-variant banks fold their variant axis into the scenario axis
before dispatch (``solve_variant_bank``), so the shards see an ordinary,
taller scenario batch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import cuda_dp
from repro_torch.core import sweep as SW
from repro_torch.core.spec import MeshSpec
from repro_torch.device import resolve_device, resolve_dtype

__all__ = [
    "KERNELS",
    "ShardMesh",
    "mesh_from_spec",
    "scenario_shards",
    "sharded_dp_tables",
    "sharded_optimal_dp",
]

#: Per-shard DP programs: the dense CUDA kernel's wrapper, or its plain version.
KERNELS = ("cuda", "torch")


@dataclass(frozen=True)
class ShardMesh:
    """The 1-D scenario mesh: one device per shard and
    (``kind="distributed"``) the process group whose rank ``r`` owns shard
    ``r``; ``group`` is ``None`` for shards of this process."""

    devices: tuple[torch.device, ...]
    group: object | None = None


def scenario_shards(n_shards: int | None = None, *, device=None) -> int:
    """The shard count a local sharded solve will use.

    On a card, ``None`` means every card (``torch.cuda.device_count()``)
    and an explicit ``n_shards`` must not exceed it; fewer is allowed. With
    ``device="cpu"`` the shards are simulated: ``None`` means 1 and any
    ``n_shards >= 1`` is allowed."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        if n_shards is None:
            return 1
        if n_shards < 1:
            raise ValueError(f"n_shards={n_shards} out of range [1, inf) "
                             f"(simulated CPU shards)")
        return int(n_shards)
    avail = torch.cuda.device_count()
    if n_shards is None:
        return avail
    if not 1 <= n_shards <= avail:
        raise ValueError(
            f"n_shards={n_shards} out of range [1, {avail}] "
            f"(local CUDA devices: {avail})")
    return int(n_shards)


def _pad_to_multiple(S: int, n_shards: int) -> int:
    """Rows to append so ``S + pad`` divides evenly into ``n_shards``
    equal shards (0 when it already does)."""
    return (-S) % n_shards


def _ensure_distributed(mesh_spec: MeshSpec) -> None:
    """Bring up the default process group from a ``kind="distributed"``
    spec, once per process. ``coordinator=None`` asserts that the caller
    already initialised it."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if mesh_spec.coordinator is None:
        raise RuntimeError(
            "MeshSpec(kind='distributed', coordinator=None) needs the default "
            "torch.distributed process group, and none is initialised: call "
            "torch.distributed.init_process_group first, or give the spec a "
            "coordinator")
    if mesh_spec.num_processes is None or mesh_spec.process_id is None:
        raise ValueError("a distributed MeshSpec with a coordinator needs "
                         "num_processes and process_id")
    url = mesh_spec.coordinator
    dist.init_process_group(
        "gloo", init_method=url if "://" in url else f"tcp://{url}",
        world_size=mesh_spec.num_processes, rank=mesh_spec.process_id)


def _rank_device(rank: int, device: torch.device) -> torch.device:
    if device.type == "cpu":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def mesh_from_spec(mesh_spec: MeshSpec | None = None,
                   n_shards: int | None = None, *, device=None) -> ShardMesh:
    """The shard devices a :class:`~repro_torch.core.spec.MeshSpec`
    describes, the multi-host seam.

    ``None`` or ``kind="local"``: the first ``n_shards`` cards (or
    simulated CPU shards, see :func:`scenario_shards`); an explicit
    ``n_shards`` wins over the spec's. ``kind="distributed"``: one device
    per rank of the default group (initialised here from the spec if it
    has a coordinator), ``n_shards`` defaulting to the world size."""
    dev = resolve_device(device)
    want = n_shards if n_shards is not None else (
        None if mesh_spec is None else mesh_spec.n_shards)
    if mesh_spec is None or mesh_spec.kind == "local":
        n = scenario_shards(want, device=dev)
        devices = (dev,) * n if dev.type == "cpu" else tuple(
            torch.device("cuda", i) for i in range(n))
        return ShardMesh(devices)
    import torch.distributed as dist

    _ensure_distributed(mesh_spec)
    world = dist.get_world_size()
    if want is None:
        want = world
    elif not 1 <= want <= world:
        raise ValueError(
            f"n_shards={want} out of range [1, {world}] "
            f"(global ranks: {world})")
    return ShardMesh(tuple(_rank_device(r, dev) for r in range(want)),
                     group=dist.group.WORLD)


def _shard_rows(a: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Rows ``lo..hi-1`` of ``a`` padded with replicas of its last row."""
    S = a.shape[0]
    if hi <= S:
        return a[lo:hi]
    return a[np.minimum(np.arange(lo, hi), S - 1)]


def _solve_shard(C: np.ndarray, ns: np.ndarray, combine: str, kernel: str,
                 device: torch.device, dtype: torch.dtype):
    fn = cuda_dp.dense_dp if kernel == "cuda" else cuda_dp.dense_dp_plain
    C_t = torch.from_numpy(np.ascontiguousarray(C)).to(device=device, dtype=dtype)
    ns_t = torch.from_numpy(ns.astype(np.int32)).to(device)
    return fn(C_t, ns_t, combine)


def sharded_dp_tables(
    C: np.ndarray,
    combine: str = "sum",
    ns: np.ndarray | None = None,
    n_shards: int | None = None,
    kernel: str = "cuda",
    mesh_spec: MeshSpec | None = None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
):
    """(dp_per_k, parents) DP tables with the scenario axis sharded.

    The multi-device twin of ``cuda_dp.cuda_dp_tables`` (``kernel="cuda"``)
    and ``plain_dp_tables`` (``"torch"``): the same return contract and
    frozen-row ``ns`` semantics, node-identical outputs. ``C`` is a float64
    (S, N, L, L) host tensor, cast to ``dtype`` on each shard's device;
    scenario counts that do not divide the shard count are padded with
    replicas of the last scenario, dropped before returning."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown shard kernel {kernel!r}; options: {list(KERNELS)}")
    dtype = resolve_dtype(dtype)
    C = np.asarray(C, dtype=np.float64)
    Sn, N, L, _ = C.shape
    mesh = mesh_from_spec(mesh_spec, n_shards, device=device)
    shards = len(mesh.devices)
    ns_arr = np.full(Sn, N, dtype=np.int64) if ns is None \
        else np.asarray(ns, dtype=np.int64)
    if N == 1 or Sn == 0:  # kernel-free cases, as on one device
        return cuda_dp._trivial_tables(
            C[:, 0, 0, :].astype(cuda_dp._np_dtype(dtype)), Sn, N, L)
    per = (Sn + _pad_to_multiple(Sn, shards)) // shards

    def solve(i: int):
        lo, hi = i * per, (i + 1) * per
        return _solve_shard(_shard_rows(C, lo, hi), _shard_rows(ns_arr, lo, hi),
                            combine, kernel, mesh.devices[i], dtype)

    if mesh.group is None:
        # launch every shard before reading any back: cards run in parallel
        outs = [solve(i) for i in range(shards)]
        parts = [torch.cat([o[j].cpu() for o in outs]) for j in range(3)]
    else:
        parts = _gathered(solve, mesh, per, N, L, dtype)
    dp0, dps, args = (p[:Sn].numpy() for p in parts)
    return SW._dp_tables_to_numpy(dp0, dps, args, Sn, N, L)


def _gathered(solve, mesh: ShardMesh, per: int, N: int, L: int,
              dtype: torch.dtype) -> list[torch.Tensor]:
    """This rank's shard solved, every rank's gathered on the host:
    ``[dp0, dps, args]`` over the first ``len(mesh.devices)`` ranks."""
    import torch.distributed as dist

    shards = len(mesh.devices)
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank < shards:
        mine = [t.cpu().contiguous() for t in solve(rank)]
    else:  # a rank beyond the shard count sends a placeholder
        mine = [torch.zeros((per, L), dtype=dtype),
                torch.zeros((per, N - 1, L), dtype=dtype),
                torch.zeros((per, N - 1, L), dtype=torch.int32)]
    parts = []
    for t in mine:
        out = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(out, t, group=mesh.group)
        parts.append(torch.cat(out[:shards]))
    return parts


def sharded_optimal_dp(
    C: np.ndarray,
    combine: str = "sum",
    return_all_k: bool = False,
    n_devices: np.ndarray | Sequence[int] | int | None = None,
    n_shards: int | None = None,
    kernel: str = "cuda",
    mesh_spec: MeshSpec | None = None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
):
    """Exact split DP with the scenario axis sharded over devices: the
    entry behind ``batched_optimal_dp(backend="sharded")``, with the same
    arguments and results, plus ``n_shards`` (see :func:`scenario_shards`),
    ``kernel`` (``"cuda"`` or ``"torch"``) and ``mesh_spec``. Results are
    node-identical to ``backend="cuda"`` (``"torch"`` for
    ``kernel="torch"``) on the same ``device`` and ``dtype``."""
    Sn, N, L, ns = SW._validate_dp_inputs(C, return_all_k, n_devices)
    t0 = time.perf_counter()
    dp_per_k, parents = sharded_dp_tables(C, combine, ns=ns, n_shards=n_shards,
                                          kernel=kernel, mesh_spec=mesh_spec,
                                          device=device, dtype=dtype)
    return SW._results_from_dp_tables(dp_per_k, parents, L, N, Sn, "sharded",
                                      ns, return_all_k, t0)
