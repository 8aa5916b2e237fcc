"""Planner tier: one serializable request contract through every layer.

The port's counterpart of ``repro.core.spec``, line for line but for the
dispatch:

* :class:`PlanSpec` — a frozen, declarative description of ONE planning
  request: what to solve (scenario tensor shape / embedded surface
  problem), how (solver + backend + combine + mesh), and under which
  constraints (fleet-size vector, channel weights, energy budget,
  variant bank, accuracy floor). ``to_json``/``from_json`` round-trip
  every field exactly — finite floats bit-exact via ``repr``, non-finite
  floats through an explicit ``{"__float__": ...}`` tag so the payload
  is strict, NaN-free JSON — and the spec pickles, so it crosses both
  ``json`` and ``multiprocessing`` boundaries. The JSON schema is the
  reference's: the embedded dataclasses are the port's own copies
  (:mod:`repro_torch.core.latency`) under the same names and fields, so
  a payload written by either package decodes in the other.

* :class:`PlannerService` — the execution tier that owns dispatch: it
  resolves a spec (plus its big operands — a stacked cost tensor, a
  list of cost models) to the batched implementations. The public kwarg
  entry points (``solve_batched`` / ``solve_multi_channel`` /
  ``solve_variant_bank``, ``plan_split_batch``, ``build_surfaces``) are
  thin shims that construct a spec and delegate here, so the spec path
  and the kwargs path are the SAME code and bit-identical by
  construction. Where the work runs is not part of the request: the
  service holds ``device`` and ``dtype`` (``device=None`` is the card)
  and hands them to each implementation, so a spec's JSON stays the
  reference's.

* Backends resolve through the port's own dispatch
  (:func:`repro_torch.core.sweep._resolve_backend`): ``None`` means
  ``"cuda"`` for ``batched_dp`` and ``"numpy"`` for the batched
  heuristics; ``"jax"`` and ``"pallas"`` are refused by name
  (``ValueError``), also in a spec the reference wrote. Every builder
  here defaults to ``backend=None``.

* :class:`MeshSpec` — the multi-host seam for ``backend="sharded"``: the
  shard devices are built from the spec
  (:func:`repro_torch.core.shard.mesh_from_spec`); any other backend
  refuses a spec that carries one, with the reference's message.

* :func:`build_surfaces_from_spec` — the module-level (hence picklable)
  worker a :class:`~repro_torch.core.async_replan.SurfaceRebuilder`
  submits to a ``ProcessPoolExecutor``: the spec's JSON ships to the
  worker with the device and dtype as plain names, the surfaces ship
  back, and the generation/swap semantics in the parent are untouched.

Import discipline: this module imports only the leaf cost-model layer
(:mod:`repro_torch.core.latency`) at module scope; the solver/surface
layers load lazily inside :class:`PlannerService` methods, so ``spec``
sits below every layer it orchestrates and anything can import it.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.latency import (
    COST_CHANNELS,
    BottleneckVariant,
    ContentionModel,
    DeviceProfile,
    LayerCost,
    LinkProfile,
    ModelCostProfile,
    SplitCostModel,
)

__all__ = [
    "MeshSpec",
    "PlanSpec",
    "PlannerService",
    "ScenarioRef",
    "SurfaceAxes",
    "build_surfaces_from_spec",
    "solve_from_json",
]


@dataclass(frozen=True)
class MeshSpec:
    """How to build the ``backend="sharded"`` shards (the reference's
    fields and JSON schema).

    ``kind="local"`` (default): the first ``n_shards`` cards of this
    process (``None`` = all of them; simulated shards on the CPU).
    ``kind="distributed"``: one shard per rank of the default
    ``torch.distributed`` group, brought up once per process with the
    ``gloo`` backend from ``coordinator`` (``host:port``, or a URL such as
    ``file:///path``) / ``num_processes`` / ``process_id``; a
    ``coordinator`` of ``None`` means the caller already initialised the
    group (:func:`repro_torch.core.shard.mesh_from_spec`). ``axis`` names
    the scenario axis. Hashable, as in the reference."""

    kind: str = "local"  # "local" | "distributed"
    n_shards: int | None = None
    axis: str = "s"
    coordinator: str | None = None  # "host:port"
    num_processes: int | None = None
    process_id: int | None = None

    def __post_init__(self):
        if self.kind not in ("local", "distributed"):
            raise ValueError(f"unknown mesh kind {self.kind!r}; "
                             f"options: ['local', 'distributed']")


@dataclass(frozen=True)
class ScenarioRef:
    """What a spec's scenario axis refers to.

    ``kind`` names the operand family the service expects alongside the
    spec: ``"tensor"`` (a stacked ``(S, N, L, L)`` cost tensor),
    ``"channels"`` (``(ch, S, N, L, L)``), ``"variant_bank"``
    (``(V, S, N, L, L)``), ``"models"`` (a list of cost models), or
    ``"surface"`` (no operand — the problem is embedded in the spec's
    ``cost_model``/``protocols``/``surface`` fields). ``shape`` pins the
    operand shape for validation at resolve time."""

    kind: str
    shape: tuple[int, ...] | None = None
    count: int | None = None

    _KINDS = ("tensor", "channels", "variant_bank", "models", "surface")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown scenario kind {self.kind!r}; "
                             f"options: {list(self._KINDS)}")


@dataclass(frozen=True)
class SurfaceAxes:
    """The (packet-time × loss) grid axes of a surface-building spec.

    ``loss_p`` keeps the :func:`~repro_torch.core.surface.build_surfaces`
    convention: ``None`` entries resolve to each protocol's base loss;
    a ``None`` axis means base loss only. ``chunk_candidates`` are the
    explicit activation-chunk candidates (``None`` = per-protocol
    defaults)."""

    pt_scale: tuple[float, ...]
    loss_p: tuple[float | None, ...] | None
    chunk_candidates: tuple[int, ...] | None = None


@dataclass(frozen=True)
class PlanSpec:
    """One declarative, serializable planning request.

    Every field is a frozen primitive / tuple / registered frozen
    dataclass, so the spec round-trips exactly through
    :meth:`to_json`/:meth:`from_json` AND through ``pickle`` — the
    contract that lets a request cross a process boundary. Construct
    directly, or via the builders (:func:`tensor_spec`,
    :func:`channels_spec`, :func:`variant_bank_spec`,
    :func:`models_spec`, :func:`surfaces_spec`) the kwarg shims use.

    ``backend`` is a port backend name or ``None`` (resolved per solver
    by :func:`repro_torch.core.sweep._resolve_backend`). ``n_devices`` is
    the fleet-size vector: ``None`` (tensor width), one ``int`` for every
    scenario, or a per-scenario tuple. ``solver_options`` carries
    solver-specific kwargs (``beam_width``, ``return_all_k``, ...) as
    sorted ``(key, value)`` pairs so the spec stays hashable-by-field and
    order-insensitive."""

    solver: str = "batched_dp"
    backend: str | None = None
    combine: str = "sum"
    scenario: ScenarioRef | None = None
    n_devices: int | tuple[int, ...] | None = None
    channels: tuple[str, ...] | None = None
    channel_weights: tuple[float, ...] | None = None
    channel_combines: tuple[str, ...] | None = None
    energy_budget: float | tuple[float, ...] | None = None
    variants: tuple[BottleneckVariant, ...] | None = None
    accuracy_proxy: tuple[float, ...] | None = None
    accuracy_floor: float | None = None
    cost_model: SplitCostModel | None = None
    protocols: tuple[tuple[str, LinkProfile], ...] | None = None
    surface: SurfaceAxes | None = None
    mesh: MeshSpec | None = None
    solver_options: tuple[tuple[str, object], ...] = ()

    def options(self) -> dict:
        """``solver_options`` as a plain kwargs dict."""
        return dict(self.solver_options)

    def to_json(self) -> str:
        """Strict (NaN-free) JSON encoding; exact field round-trip via
        :meth:`from_json`. Finite floats survive bit-for-bit (``repr``
        round-trip); non-finite floats are tagged
        ``{"__float__": "inf"|"-inf"|"nan"}`` so ``allow_nan=False``
        always holds."""
        return json.dumps(_encode(self), sort_keys=True, allow_nan=False)

    @classmethod
    def from_json(cls, payload: str) -> "PlanSpec":
        obj = _decode(json.loads(payload, parse_constant=_reject_constant))
        if not isinstance(obj, cls):
            raise ValueError(
                f"payload decodes to {type(obj).__name__}, not PlanSpec")
        return obj


# ---------------------------------------------------------------------------
# JSON codec (tagged, recursive, NaN-free)
# ---------------------------------------------------------------------------

# every dataclass a PlanSpec may embed, by name. Decoding instantiates
# ONLY these types — an unknown __type__ tag is an error, not an eval.
_SPEC_TYPES: dict[str, type] = {
    cls.__name__: cls
    for cls in (
        LayerCost,
        DeviceProfile,
        LinkProfile,
        ContentionModel,
        BottleneckVariant,
        ModelCostProfile,
        SplitCostModel,
        ScenarioRef,
        SurfaceAxes,
        MeshSpec,
        PlanSpec,
    )
}


def _reject_constant(token: str):
    raise ValueError(f"non-strict JSON constant {token!r} in PlanSpec "
                     f"payload (the codec tags non-finite floats)")


def _encode(obj):
    if obj is None or isinstance(obj, (bool, str)):
        return obj
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        f = float(obj)
        if math.isfinite(f):
            return f
        tag = "nan" if math.isnan(f) else ("inf" if f > 0 else "-inf")
        return {"__float__": tag}
    if isinstance(obj, tuple):
        return {"__tuple__": [_encode(v) for v in obj]}
    if isinstance(obj, list):
        return [_encode(v) for v in obj]
    name = type(obj).__name__
    if dataclasses.is_dataclass(obj) and _SPEC_TYPES.get(name) is type(obj):
        out: dict = {"__type__": name}
        for f in dataclasses.fields(obj):
            out[f.name] = _encode(getattr(obj, f.name))
        return out
    raise TypeError(f"PlanSpec JSON codec cannot encode "
                    f"{type(obj).__name__}: {obj!r}")


_FLOAT_TAGS = {"nan": float("nan"), "inf": float("inf"),
               "-inf": float("-inf")}


def _decode(obj):
    if isinstance(obj, dict):
        if set(obj) == {"__float__"}:
            return _FLOAT_TAGS[obj["__float__"]]
        if set(obj) == {"__tuple__"}:
            return tuple(_decode(v) for v in obj["__tuple__"])
        if "__type__" in obj:
            try:
                cls = _SPEC_TYPES[obj["__type__"]]
            except KeyError:
                raise ValueError(f"unknown PlanSpec type tag "
                                 f"{obj['__type__']!r}") from None
            return cls(**{k: _decode(v) for k, v in obj.items()
                          if k != "__type__"})
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# Normalization: kwargs values -> frozen spec fields, value-preserving
# ---------------------------------------------------------------------------


def _norm_n(n) -> int | tuple[int, ...] | None:
    """Fleet sizes -> None / int / tuple[int, ...]. Value-preserving:
    the solver re-derives the exact same ``np.int64`` vector from the
    tuple, so spec-path results stay bit-identical."""
    if n is None or isinstance(n, (int, np.integer)):
        return None if n is None else int(n)
    return tuple(int(v) for v in np.asarray(n).reshape(-1))


def _norm_budget(b) -> float | tuple[float, ...] | None:
    if b is None:
        return None
    arr = np.asarray(b, dtype=np.float64)
    if arr.ndim == 0:
        return float(arr)
    return tuple(float(v) for v in arr)


def _norm_floats(seq) -> tuple[float, ...] | None:
    if seq is None:
        return None
    return tuple(float(v) for v in np.asarray(seq, dtype=np.float64))


def _norm_loss(loss_p) -> tuple[float | None, ...] | None:
    if loss_p is None:
        return None
    return tuple(None if lp is None else float(lp) for lp in loss_p)


def _norm_options(options: Mapping[str, object]) -> tuple:
    return tuple(sorted(options.items()))


def _norm_variants(variants) -> tuple[BottleneckVariant, ...] | None:
    return None if variants is None else tuple(variants)


# ---------------------------------------------------------------------------
# Spec builders — what the kwarg shims construct
# ---------------------------------------------------------------------------


def tensor_spec(C, *, solver="batched_dp", combine="sum", backend=None,
                n_devices=None, mesh=None, **options) -> PlanSpec:
    """Spec for a plain batched solve over a stacked ``(S, N, L, L)``
    tensor (the :func:`repro_torch.core.sweep.solve_batched` contract)."""
    return PlanSpec(
        solver=solver, backend=backend, combine=combine,
        scenario=ScenarioRef(kind="tensor",
                             shape=tuple(int(d) for d in np.shape(C))),
        n_devices=_norm_n(n_devices), mesh=mesh,
        solver_options=_norm_options(options),
    )


def channels_spec(C, *, channels=COST_CHANNELS, solver="batched_dp",
                  combine="sum", backend=None, n_devices=None,
                  energy_budget=None, channel_weights=None,
                  channel_combines=None, mesh=None, **options) -> PlanSpec:
    """Spec for a multi-channel solve over ``(ch, S, N, L, L)`` (the
    :func:`repro_torch.core.sweep.solve_multi_channel` contract)."""
    return PlanSpec(
        solver=solver, backend=backend, combine=combine,
        scenario=ScenarioRef(kind="channels",
                             shape=tuple(int(d) for d in np.shape(C))),
        n_devices=_norm_n(n_devices),
        channels=tuple(channels),
        channel_weights=_norm_floats(channel_weights),
        channel_combines=(None if channel_combines is None
                          else tuple(channel_combines)),
        energy_budget=_norm_budget(energy_budget), mesh=mesh,
        solver_options=_norm_options(options),
    )


def variant_bank_spec(C, *, solver="batched_dp", combine="sum",
                      backend=None, n_devices=None, accuracy_proxy=None,
                      accuracy_floor=None, mesh=None, **options) -> PlanSpec:
    """Spec for a joint (split, variant) solve over ``(V, S, N, L, L)``
    (the :func:`repro_torch.core.sweep.solve_variant_bank` contract)."""
    return PlanSpec(
        solver=solver, backend=backend, combine=combine,
        scenario=ScenarioRef(kind="variant_bank",
                             shape=tuple(int(d) for d in np.shape(C))),
        n_devices=_norm_n(n_devices),
        accuracy_proxy=_norm_floats(accuracy_proxy),
        accuracy_floor=(None if accuracy_floor is None
                        else float(accuracy_floor)),
        mesh=mesh, solver_options=_norm_options(options),
    )


def models_spec(cost_models, *, n_devices, solver="batched_dp",
                backend=None, energy_budget=None, variants=None,
                accuracy_floor=None, mesh=None, **options) -> PlanSpec:
    """Spec for a cost-model batch (the
    :func:`repro_torch.core.planner.plan_split_batch` contract). The
    models travel ALONGSIDE the spec (they are the big operand); the spec
    records the request shape."""
    combine = "sum"
    if cost_models and cost_models[0].objective == "bottleneck":
        combine = "max"
    return PlanSpec(
        solver=solver, backend=backend, combine=combine,
        scenario=ScenarioRef(kind="models", count=len(cost_models)),
        n_devices=_norm_n(n_devices),
        energy_budget=_norm_budget(energy_budget),
        variants=_norm_variants(variants),
        accuracy_floor=(None if accuracy_floor is None
                        else float(accuracy_floor)),
        mesh=mesh, solver_options=_norm_options(options),
    )


def surfaces_spec(cost_model, protocols, sizes, *, pt_scale, loss_p,
                  solver="batched_beam", backend=None, beam_width=8,
                  chunk_candidates=None, energy_budget=None, variants=None,
                  accuracy_floor=None, mesh=None) -> PlanSpec:
    """Spec for a surface-family build (the
    :func:`repro_torch.core.surface.build_surfaces` contract). Unlike the
    tensor specs this one is SELF-CONTAINED — cost model, protocol
    links, and grid axes are all spec fields — which is exactly what
    lets a rebuild cross a process boundary
    (:func:`build_surfaces_from_spec`). The axes become Python floats
    here, so ``np.float32`` axes price the nodes as their float64 values
    would."""
    if isinstance(protocols, Mapping):
        proto_pairs = tuple(protocols.items())
    else:
        proto_pairs = tuple(protocols)
    combine = "max" if cost_model.objective == "bottleneck" else "sum"
    return PlanSpec(
        solver=solver, backend=backend, combine=combine,
        scenario=ScenarioRef(kind="surface"),
        n_devices=tuple(int(n) for n in sizes),
        energy_budget=_norm_budget(energy_budget),
        variants=_norm_variants(variants),
        accuracy_floor=(None if accuracy_floor is None
                        else float(accuracy_floor)),
        cost_model=cost_model,
        protocols=proto_pairs,
        surface=SurfaceAxes(
            pt_scale=tuple(float(s) for s in pt_scale),
            loss_p=_norm_loss(loss_p),
            chunk_candidates=(None if chunk_candidates is None
                              else tuple(int(c) for c in chunk_candidates)),
        ),
        mesh=mesh,
        solver_options=(("beam_width", int(beam_width)),),
    )


# ---------------------------------------------------------------------------
# PlannerService — the execution tier
# ---------------------------------------------------------------------------


class PlannerService:
    """Resolves a :class:`PlanSpec` to the batched planning engines.

    The service owns dispatch: the public kwarg entry points
    (``solve_batched``/``solve_multi_channel``/``solve_variant_bank``,
    ``plan_split_batch``, ``build_surfaces``) are shims that build a
    spec and call one of these methods, and the methods call the single
    retained implementation — so spec-path and kwargs-path results are
    the same code path and bit-identical by construction.

    ``device`` / ``dtype`` say where and in which type the DP's
    ``"cuda"`` and ``"torch"`` backends run (``device=None`` is the card,
    ``RuntimeError`` without one); they are not part of the spec.
    Stateless and cheap: construct freely (one per call site is fine)."""

    def __init__(self, device=None, dtype: torch.dtype = torch.float32):
        self.device = device
        self.dtype = dtype

    # -- operand validation -------------------------------------------------
    @staticmethod
    def _check_operand(spec: PlanSpec, kind: str, shape=None) -> None:
        ref = spec.scenario
        if ref is None:
            return  # hand-built spec without a ref: trust the caller
        if ref.kind != kind:
            raise ValueError(f"spec scenario kind {ref.kind!r} does not "
                             f"match operand kind {kind!r}")
        if shape is not None and ref.shape is not None \
                and tuple(ref.shape) != tuple(shape):
            raise ValueError(f"spec scenario shape {ref.shape} does not "
                             f"match operand shape {tuple(shape)}")

    # -- solves over stacked tensors ---------------------------------------
    def solve(self, spec: PlanSpec, C):
        """Resolve a ``"tensor"`` spec against its stacked cost tensor."""
        from repro_torch.core import sweep as SW

        self._check_operand(spec, "tensor", np.shape(C))
        return SW._solve_batched_impl(
            C, solver=spec.solver, combine=spec.combine,
            backend=spec.backend, n_devices=spec.n_devices,
            mesh_spec=spec.mesh, device=self.device, dtype=self.dtype,
            **spec.options())

    def solve_multi_channel(self, spec: PlanSpec, C):
        """Resolve a ``"channels"`` spec against ``(ch, S, N, L, L)``."""
        from repro_torch.core import sweep as SW

        self._check_operand(spec, "channels", np.shape(C))
        return SW._solve_multi_channel_impl(
            C, channels=spec.channels or COST_CHANNELS,
            solver=spec.solver, combine=spec.combine, backend=spec.backend,
            n_devices=spec.n_devices, energy_budget=spec.energy_budget,
            channel_weights=spec.channel_weights,
            channel_combines=spec.channel_combines,
            mesh_spec=spec.mesh, device=self.device, dtype=self.dtype,
            **spec.options())

    def solve_variant_bank(self, spec: PlanSpec, C):
        """Resolve a ``"variant_bank"`` spec against ``(V, S, N, L, L)``."""
        from repro_torch.core import sweep as SW

        self._check_operand(spec, "variant_bank", np.shape(C))
        return SW._solve_variant_bank_impl(
            C, solver=spec.solver, combine=spec.combine,
            backend=spec.backend, n_devices=spec.n_devices,
            accuracy_proxy=spec.accuracy_proxy,
            accuracy_floor=spec.accuracy_floor,
            mesh_spec=spec.mesh, device=self.device, dtype=self.dtype,
            **spec.options())

    # -- cost-model batches --------------------------------------------------
    def plan(self, spec: PlanSpec, cost_models: Sequence[SplitCostModel]):
        """Resolve a ``"models"`` spec against its cost-model batch."""
        from repro_torch.core import planner as PL

        self._check_operand(spec, "models")
        if spec.scenario is not None and spec.scenario.count is not None \
                and spec.scenario.count != len(cost_models):
            raise ValueError(
                f"spec records {spec.scenario.count} cost models, got "
                f"{len(cost_models)}")
        n = spec.n_devices
        if n is None:
            raise ValueError("a 'models' spec needs n_devices")
        return PL._plan_split_batch_impl(
            cost_models, n, solver=spec.solver, backend=spec.backend,
            energy_budget=spec.energy_budget, variants=spec.variants,
            accuracy_floor=spec.accuracy_floor, mesh_spec=spec.mesh,
            device=self.device, dtype=self.dtype, **spec.options())

    # -- surface families ----------------------------------------------------
    def build_surfaces(self, spec: PlanSpec):
        """Resolve a self-contained ``"surface"`` spec to the surface
        family ``{n_devices: DegradationSurface}``."""
        from repro_torch.core import surface as SF

        self._check_operand(spec, "surface")
        if spec.cost_model is None or spec.protocols is None \
                or spec.surface is None:
            raise ValueError("a 'surface' spec needs cost_model, protocols "
                             "and surface axes")
        opts = spec.options()
        return SF._build_surfaces_impl(
            spec.cost_model, dict(spec.protocols), spec.n_devices,
            pt_scale=spec.surface.pt_scale, loss_p=spec.surface.loss_p,
            solver=spec.solver, backend=spec.backend,
            beam_width=int(opts.get("beam_width", 8)),
            chunk_candidates=spec.surface.chunk_candidates,
            energy_budget=spec.energy_budget, variants=spec.variants,
            accuracy_floor=spec.accuracy_floor, mesh_spec=spec.mesh,
            device=self.device, dtype=self.dtype)


# ---------------------------------------------------------------------------
# Process-boundary workers (module-level => picklable)
# ---------------------------------------------------------------------------


def _service(device: str | None, dtype: str | torch.dtype | None) -> PlannerService:
    """A service from plain, picklable names: ``device`` a device string
    (``None``: the card), ``dtype`` a ``torch`` type name such as
    ``"float64"`` (``None``: float32)."""
    if dtype is None:
        dtype = torch.float32
    elif isinstance(dtype, str):
        dtype = getattr(torch, dtype.removeprefix("torch."))
    return PlannerService(device=device, dtype=dtype)


def build_surfaces_from_spec(spec: PlanSpec | str, device: str | None = None,
                             dtype: str | None = None):
    """Build a surface family from a spec — THE process-pool rebuild
    worker. Module-level so ``ProcessPoolExecutor`` can pickle it;
    accepts either a :class:`PlanSpec` (pickled across the boundary) or
    its :meth:`~PlanSpec.to_json` payload, and ``device`` / ``dtype`` as
    plain names (``"cuda"``, ``"float32"``; ``None`` is the card in
    float32). Returns the ``{n_devices: DegradationSurface}`` family,
    which pickles back to the parent for the ordinary generation/swap
    adoption path."""
    if isinstance(spec, str):
        spec = PlanSpec.from_json(spec)
    return _service(device, dtype).build_surfaces(spec)


def solve_from_json(payload: str, C, device: str | None = None,
                    dtype: str | None = None):
    """Solve a JSON-encoded ``"tensor"`` spec against ``C`` — the
    out-of-process twin of :meth:`PlannerService.solve` (``device`` /
    ``dtype`` as in :func:`build_surfaces_from_spec`)."""
    return _service(device, dtype).solve(PlanSpec.from_json(payload), C)
