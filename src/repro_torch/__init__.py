"""PyTorch / CUDA port of the split-learning planner for NVIDIA Hopper.

``repro_torch`` mirrors the module names of the JAX reference package
``repro`` so each counterpart is easy to find, and imports nothing of it:
the host-side cost model (``core.latency``, ``core.profiles``,
``models.graph``) is the port's own copy, kept in the reference's exact
operation order. The exact split DP runs on two hand-written CUDA
kernels (``csrc/split_dp.cu``, bound in ``core.cuda_dp``).

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when no card is present. The CPU is used only when a caller passes
``device="cpu"``, and then the kernels' plain PyTorch versions run.
"""

from repro_torch.device import resolve_device, resolve_dtype

__all__ = ["resolve_device", "resolve_dtype"]
