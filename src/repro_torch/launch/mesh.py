"""Production mesh construction: the port's counterpart of
``repro.launch.mesh``, on ``torch.distributed``'s ``init_device_mesh``.

A mesh spans the ranks of the default process group, so the caller brings
the group up first: real ranks (``torchrun``, or
``init_process_group(..., rank=r, world_size=n)`` with a ``tcp://`` or
``file://`` address), or the ``fake`` backend of
``torch.testing._internal.distributed.fake_pg``, in which one process
stands for every rank and no data moves (the dry run's pattern, the
counterpart of the reference's ``--xla_force_host_platform_device_count``).
``device=None`` is the card, a ``RuntimeError`` without one, as everywhere
in the port; the dry run passes ``device="cpu"``.
"""

from __future__ import annotations

import math

from repro_torch.device import resolve_device

__all__ = ["make_host_mesh", "make_production_mesh"]


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh spans the default process group: call "
                           f"torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh {axes} needs a world of "
                         f"{math.prod(shape)} ranks, the process group has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(multi_pod: bool = False, device=None):
    """Single pod: 16x16 chips (data, model), 256 ranks. Multi-pod: 2 pods x
    256 chips (pod, data, model), 512 ranks — the 'pod' axis crosses the
    slower inter-pod network. ``ValueError`` when the world has another
    size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(model_parallel: int = 1, device=None):
    """A (world / model_parallel, model_parallel) (data, model) mesh over
    the ranks of the default process group (tests, examples)."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide {n} ranks")
    return _mesh((n // model_parallel, model_parallel), ("data", "model"), device)
