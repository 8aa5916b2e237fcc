"""Op-level accounting of one step: flops, bytes, collectives and live
memory, counted while the step runs.

The port's counterpart of ``repro.parallel.hlo_analysis`` and of the
figures the reference's dry run reads off XLA's compiled program
(``cost_analysis()``, ``memory_analysis()``, the collectives of the
optimized HLO). The port compiles no program. :func:`count_step` runs one
call of a step eagerly under :class:`OpCounter`, a ``TorchDispatchMode``,
on ``meta`` tensors (shapes and types, no data) over the ``fake`` process
group in the dry run, or on the card's own tensors, and counts what every
op that reaches the dispatcher does:

* **flops** (XLA's ``flops``). Products as ``torch.utils.flop_counter``
  counts them (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``convolution``,
  the ``_scaled_dot_product_*`` ops), and ``_int_mm`` as 2·M·N·K. The
  port's kernel ops as their math (:data:`KERNEL_FLOPS`): ``flash_attention``
  4·D per kept (q, k) pair (``PERF.md`` §6 row 5), ``quant_matmul`` and
  ``w8a16_matmul`` 2·M·N·K, ``ssm_scan`` its products on the pairs the
  causal mask keeps (row 6). These two make ``flops_products``. Every
  other op that computes adds one flop per element of the larger of its
  output and its largest input (``flops_other``): an elementwise op's
  output, the elements a reduction folds, as XLA's ``HloCostAnalysis``
  counts a reduce. Views, allocations, copies, casts, concatenation,
  indexing and fills add none.
* **bytes** (XLA's ``bytes accessed``): every op but a view reads each
  tensor argument once and writes each output once (an in-place op's
  output is the argument it writes; an allocation writes nothing).
* **collectives**: each c10d op (the steps' own ``dist.all_reduce``, the
  pipeline's ``batch_isend_irecv``) and each functional collective
  (DTensor's ``full_tensor`` and ``redistribute``), by kind under the
  reference's names (:data:`COLLECTIVES`; a receive is one
  ``collective-permute``, its send counts nothing), with its output bytes
  and the size of its group. Both kinds of op reach the dispatcher, so
  this one mode sees them all: a DTensor op is handed back to DTensor
  (``NotImplemented``), whose local ops and collectives then come through
  the mode.
* **live memory** (``memory_analysis().temp_size_in_bytes``): a storage
  that an op creates is live until its last tensor dies (a ``weakref``
  finalizer on the storage), as the card's allocator holds it, without
  the allocator's rounding or library workspaces. ``peak_bytes`` is the
  peak of the live bytes over the call; ``temp_bytes`` leaves out the
  storages the call returns.

The kernel ops launch through ctypes, past the dispatcher: each kernel
function reports itself (``kernels.note_kernel``), on the card where it
launches and, on tensors that hold no data, where it returns its empty
output, so a trace on ``meta`` tensors and a run on the card count the
same op, and the allocations inside the kernel function (its output and
scratch) are seen as any other op's.

What ``hlo_analysis`` answers, and the answer here:

* ``split_computations``, ``trip_count``, ``computation_multipliers``:
  XLA counts a while loop's body once, so the reference weights each body
  by its trip count. An eager step issues every trip of its loops itself
  (each layer, microbatch and attention chunk), so the counter weights
  nothing: every op it counts ran. (To keep the dry run short,
  ``launch.dryrun`` traces shallower copies of a cell and extends their
  counts over the depth and the microbatches.)
* ``shape_bytes``: :func:`tensor_bytes`.
* ``weighted_collective_bytes``: :func:`weighted_collective_bytes`, the
  reference's ring factors (``_wire_factor``, a copy) on each
  collective's own group size.

How the counts differ from XLA's. XLA counts its program after its own
optimisation: it fuses elementwise chains, so its ``bytes accessed``
counts what each fusion reads and writes where the port counts every
eager op's operands (the port's bytes are the larger); it keeps
transcendental ops (exp, rsqrt, ...) out of ``flops``, the port counts
them as one each; it drops dead and duplicate work; and its
``cost_analysis`` counts a while body once (a scanned layer stack as one
layer). Its temporaries are the buffers of its own schedule, the port's
the eager allocations in the order the step makes them.
"""

from __future__ import annotations

import weakref
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels

__all__ = ["COLLECTIVES", "KERNEL_FLOPS", "OpCounter", "OpTrace", "count_step",
           "tensor_bytes", "weighted_collective_bytes"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d and functional collective ops by name, under the reference's kinds;
# any other collective keeps its own name
_KINDS = {
    **dict.fromkeys(("allreduce_", "allreduce_coalesced_", "all_reduce", "all_reduce_",
                     "all_reduce_coalesced", "all_reduce_coalesced_"), "all-reduce"),
    **dict.fromkeys(("allgather_", "_allgather_base_", "allgather_coalesced_",
                     "allgather_into_tensor_coalesced_", "all_gather_into_tensor",
                     "all_gather_into_tensor_out", "all_gather_into_tensor_coalesced"),
                    "all-gather"),
    **dict.fromkeys(("reduce_scatter_", "_reduce_scatter_base_",
                     "reduce_scatter_tensor_coalesced_", "reduce_scatter_tensor",
                     "reduce_scatter_tensor_coalesced"), "reduce-scatter"),
    **dict.fromkeys(("alltoall_", "alltoall_base_", "all_to_all_single"), "all-to-all"),
    **dict.fromkeys(("recv_", "recv_any_source_"), "collective-permute"),
    **dict.fromkeys(("broadcast_", "broadcast"), "broadcast"),
    "scatter_": "scatter", "gather_": "gather", "reduce_": "reduce",
}
_COLLECTIVE_NS = ("c10d", "_c10d_functional", "_c10d_functional_autograd")

# ops that allocate and write nothing; that write without reading; that
# move data without computing
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
           "empty_permuted"}
_FILLS = {"zeros", "ones", "full", "arange", "scalar_tensor", "zeros_like", "ones_like",
          "full_like", "new_zeros", "new_ones", "new_full", "fill_", "zero_", "linspace",
          "eye", "tensor"}
_MOVES = {"clone", "_to_copy", "copy_", "copy", "cat", "stack", "index", "index_select",
          "gather", "scatter", "index_put", "index_put_", "_index_put_impl_", "embedding",
          "slice_backward", "select_backward", "slice_scatter", "select_scatter",
          "as_strided_scatter", "constant_pad_nd", "repeat", "flip", "roll", "_unsafe_index",
          "masked_select", "lift_fresh_copy", "contiguous", "split_with_sizes_copy",
          "unbind_copy", "narrow_copy", "expand_copy", "permute_copy", "view_copy",
          "transpose_copy", "t_copy", "unsqueeze_copy", "squeeze_copy", "_reshape_copy"}


def _tensors(x, out: list) -> list:
    """The tensors in ``x`` (nested lists, tuples and dicts) into ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s elements (a view's own, not its storage's): the
    counterpart of ``hlo_analysis.shape_bytes``."""
    return t.numel() * t.element_size()


# --------------------------------------------------------------------------
# the port's kernel ops as their math
# --------------------------------------------------------------------------


def _flash_flops(q, k, v, q_positions, kv_positions) -> int:
    """4·D flops per kept (q, k) pair of folded q (BH, Sq, D) and k (BHkv,
    Skv, D). The pairs come from the shapes, with the q rows at the last
    Sq of the Skv positions (prefill: the causal triangle), so that a
    trace without data counts what the card's run counts."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    kept = Sq * (Skv - Sq) + Sq * (Sq + 1) // 2 if Skv >= Sq else Skv * (Skv + 1) // 2
    return 4 * D * BH * kept


def _gemm_flops(a, w_q, *rest) -> int:
    """2·M·N·K of an (M, K) x (K, N) product."""
    return 2 * a.shape[0] * a.shape[1] * w_q.shape[1]


def _ssd_flops(x, b, c, dA, dt, chunk: int) -> int:
    """The SSD scan's products on x (BH, S, ph), b / c (B, S, ds) in chunks
    of ``chunk`` rows: per chunk of r rows, C·Bᵀ on the r (r + 1) / 2 pairs the causal mask keeps once
    per batch row (its H heads share B and C), and per head the masked
    (C·Bᵀ ∘ L)(dt x), C·h and the state update Bᵀ(dt x): 2 flops a
    multiply-add, ``chip_smoke.ssd_work``'s plain count."""
    BH, S, ph = x.shape
    B, _, ds = b.shape
    H = BH // B
    rows = [min(chunk, S - i * chunk) for i in range(-(-S // chunk))]
    return sum(2 * B * (r * (r + 1) // 2 * ds
                        + H * (r * (r + 1) // 2 * ph + 2 * r * ds * ph)) for r in rows)


#: flops of each kernel op (``kernels.note_kernel``'s name) from the kernel
#: function's own arguments
KERNEL_FLOPS = {
    "flash_attention": _flash_flops,
    "quant_matmul": _gemm_flops,
    "w8a16_matmul": _gemm_flops,
    "ssm_scan": _ssd_flops,
}


# --------------------------------------------------------------------------
# the counter
# --------------------------------------------------------------------------


@dataclass
class OpTrace:
    """What one call counted: flops (``flops_products`` + ``flops_other``),
    bytes read and written, the collectives in the order they were issued
    as ``(kind, output bytes, group size)``, the kernel ops' calls, and the
    live memory's peaks (``temp_bytes`` without the storages the call
    returns, ``peak_bytes`` with them)."""

    flops_products: int = 0
    flops_other: int = 0
    bytes_accessed: int = 0
    collectives: list = field(default_factory=list)
    kernels: Counter = field(default_factory=Counter)
    temp_bytes: int = 0
    peak_bytes: int = 0
    n_ops: int = 0

    @property
    def flops(self) -> int:
        return self.flops_products + self.flops_other


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


# integer tensors up to this many elements carry their values beside a
# trace's data-less tensors (positions, cursors)
_VALUE_MAX = 1 << 16


class OpCounter(TorchDispatchMode):
    """Counts the ops under it into ``self.trace`` (see the module
    docstring); :meth:`close` ends the count and fills in the memory peaks.

    A step may read a value on the host (``int(t)``, ``.item()``): decode
    reads its cache cursor, the causal skip of chunked attention the last
    position of each q chunk. A tensor that holds no data has no value to
    read, so the counter carries one beside each small integer tensor that
    the step computes from values it knows: from no tensor at all (an
    ``arange`` of positions) or from tensors that carry values, starting
    with ``values`` (``{tensor: its value}``, the step's own arguments such
    as the cursor). Each such op runs once more on the carried values on
    the CPU. A read of a data-less tensor without a value raises."""

    def __init__(self, values=None):
        from torch.utils.weak import WeakIdKeyDictionary

        super().__init__()
        self.values = WeakIdKeyDictionary(values or {})
        self.trace = OpTrace()
        self._classes: dict = {}
        self._live: dict[int, tuple[int, int]] = {}  # storage key -> (serial, bytes)
        self._events: list[tuple[int, int]] = []  # (serial, +bytes or -bytes)
        self._now = 0
        self._serial = 0
        self._open = True

    # ---- live storages ------------------------------------------------

    def _track(self, storage, key: int) -> None:
        nbytes = storage.nbytes()
        self._serial += 1
        self._live[key] = (self._serial, nbytes)
        self._events.append((self._serial, nbytes))
        self._now += nbytes
        self.trace.peak_bytes = max(self.trace.peak_bytes, self._now)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        if not self._open or key not in self._live:
            return
        serial, nbytes = self._live.pop(key)
        self._events.append((serial, -nbytes))
        self._now -= nbytes

    def close(self, outputs=None) -> OpTrace:
        """Stop counting; ``temp_bytes`` leaves out the storages of
        ``outputs`` (the call's return value; DTensors by their local
        tensors) that the call created."""
        from torch.distributed.tensor import DTensor

        out_serials = set()
        for t in tree_leaves(outputs):
            if isinstance(t, DTensor):
                t = t._local_tensor
            if isinstance(t, torch.Tensor) and _storage_key(t) in self._live:
                out_serials.add(self._live[_storage_key(t)][0])
        now = peak = 0
        for serial, nbytes in self._events:
            if serial not in out_serials:
                now += nbytes
                peak = max(peak, now)
        self.trace.temp_bytes = peak
        self._open = False
        return self.trace

    # ---- ops ------------------------------------------------------------

    def note_kernel(self, op: str, inputs: tuple, out: torch.Tensor) -> None:
        """A kernel op (``kernels.note_kernel``): its math as products."""
        tensors = [t for t in inputs if isinstance(t, torch.Tensor)]
        self.trace.flops_products += KERNEL_FLOPS[op](*inputs)
        self.trace.bytes_accessed += sum(map(tensor_bytes, tensors)) + tensor_bytes(out)
        self.trace.kernels[op] += 1

    def _class_of(self, func) -> str:
        cls = self._classes.get(func)
        if cls is None:
            name = func.overloadpacket.__name__
            if func.namespace in _COLLECTIVE_NS:
                cls = "collective" if name in _KINDS else "free"
            elif func.namespace == "prim" or func.is_view:
                cls = "free"
            elif func.overloadpacket in flop_registry or name == "_int_mm":
                cls = "product"
            elif name in _ALLOCS:
                cls = "alloc"
            elif name in _FILLS:
                cls = "fill"
            elif name in _MOVES:
                cls = "move"
            else:
                cls = "compute"
            self._classes[func] = cls
        return cls

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator) \
                or torch._C._meta_in_tls_dispatch_include() \
                or any(issubclass(t, FakeTensor) for t in types):
            # a FakeTensorMode's shape inference, not the step's work: DTensor
            # propagating a sharding the first time it meets an op, a cell
            # building its template model (nothing is allocated)
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it as local ops and collectives
        if func is torch.ops.aten._local_scalar_dense.default \
                and kernels.holds_no_data(args[0]):
            if args[0] not in self.values:
                raise RuntimeError("the step reads on the host a value of a tensor that "
                                   "holds no data and carries no value")
            return self.values[args[0]].item()
        cls = self._class_of(func)
        key = _meta_key(func, args, kwargs) if cls in _FRESH else None
        made = _MADE.get(key) if key is not None else None
        if made is not None:
            out = tree_unflatten([torch.empty_strided(m[0], m[1], dtype=m[2], device="meta")
                                  if isinstance(m, tuple) else m for m in made[0]], made[1])
        else:
            try:
                out = func(*args, **kwargs)
            except (RuntimeError, NotImplementedError):
                # an output shape that depends on values (``repeat_interleave``,
                # ``nonzero``) has no meta form: take it from the carried values
                out = self._from_values(func, args, kwargs)
                if out is None:
                    raise
        self._carry(func, args, kwargs, out)
        if cls != "free":
            fresh = self._count(func, cls, args, kwargs, out)
            if key is not None and made is None and fresh and len(_MADE) < _MADE_MAX \
                    and all(t.device.type == "meta" for t in _tensors(out, [])):
                leaves, spec = tree_flatten(out)
                _MADE[key] = ([(tuple(t.shape), t.stride(), t.dtype)
                               if isinstance(t, torch.Tensor) else t for t in leaves], spec)
        return out

    def _on_values(self, func, args, kwargs):
        """``func`` run on the CPU with each tensor input replaced by the
        value it carries (a tensor that holds data is its own value), or
        None where an input carries none."""
        from torch.utils._python_dispatch import _disable_current_modes

        leaves, spec = tree_flatten((args, kwargs))
        for i, x in enumerate(leaves):
            if isinstance(x, torch.Tensor) and kernels.holds_no_data(x):
                if x not in self.values:
                    return None
                leaves[i] = self.values[x]
            elif isinstance(x, torch.device) and x.type == "meta":
                leaves[i] = torch.device("cpu")
        a, kw = tree_unflatten(leaves, spec)
        with _disable_current_modes():
            return func(*a, **kw)

    def _carry(self, func, args, kwargs, out) -> None:
        """Carry the values of ``func``'s outputs where they are small
        integer tensors without data and each tensor input carries one."""
        outs = _tensors(out, [])
        if not outs or any(t.is_floating_point() or t.is_complex() or t.numel() > _VALUE_MAX
                           or not kernels.holds_no_data(t) for t in outs):
            return
        got = self._on_values(func, args, kwargs)
        if got is not None:
            for t, v in zip(outs, [v for v in tree_leaves(got) if isinstance(v, torch.Tensor)]):
                self.values[t] = v

    def _from_values(self, func, args, kwargs):
        """``meta`` outputs of ``func`` shaped by its result on the carried
        values (which they carry), or None."""
        from torch.utils._pytree import tree_map

        if not any(isinstance(x, torch.Tensor) for x in tree_leaves((args, kwargs))):
            return None
        got = self._on_values(func, args, kwargs)
        if got is None:
            return None

        def meta(v):
            if not isinstance(v, torch.Tensor):
                return v
            t = torch.empty(v.shape, dtype=v.dtype, device="meta")
            self.values[t] = v
            return t

        return tree_map(meta, got)

    def _written(self, func, args, kwargs) -> list:
        """The tensors a mutating op writes: its arguments marked ``(a!)``."""
        tensors = []
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                value = args[i] if i < len(args) else kwargs.get(a.name)
                _tensors(value, tensors)
        return tensors

    def _count(self, func, cls, args, kwargs, out) -> bool:
        """Count one op; True where each of its outputs is a new storage."""
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        in_keys = {_storage_key(t) for t in ins}
        created = 0
        for t in outs:
            key = _storage_key(t)
            if key not in in_keys and key not in self._live:
                self._track(t.untyped_storage(), key)
                created += 1
        mutates = func._schema.is_mutable
        if not created and not mutates and cls != "collective":
            return False  # it handed back its inputs' memory (``_unsafe_view``, ``alias``)
        trace = self.trace
        trace.n_ops += 1
        fresh = created == len(outs) and not mutates
        written = self._written(func, args, kwargs) if mutates else outs
        if cls == "alloc":
            return fresh
        out_bytes = sum(map(tensor_bytes, written))
        if cls == "fill":
            trace.bytes_accessed += out_bytes
            return fresh
        trace.bytes_accessed += sum(map(tensor_bytes, ins)) + out_bytes
        if cls == "product":
            if func.overloadpacket.__name__ == "_int_mm":
                trace.flops_products += _gemm_flops(args[0], args[1])
            else:
                trace.flops_products += flop_registry[func.overloadpacket](
                    *args, **kwargs, out_val=out)
        elif cls == "compute":
            trace.flops_other += max(t.numel() for t in ins + outs) if ins or outs else 0
        elif cls == "collective":
            trace.collectives.append((_KINDS[func.overloadpacket.__name__], out_bytes,
                                      _group_size(func, args, kwargs)))
        return fresh


# Output shapes of the ops that make new storages, by op and the shapes,
# strides and types of their ``meta`` inputs (a meta kernel is a function
# of these alone): a repeated op takes its outputs from here instead of
# running its meta kernel again, many of which are Python decompositions.
_MADE: dict = {}
_MADE_MAX = 1 << 18
_FRESH = ("alloc", "fill", "move", "compute", "product")


class _Unkeyed(Exception):
    pass


def _key_of(x):
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _Unkeyed
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_key_of(v) for v in x))
    if x is None or isinstance(x, (int, float, bool, str, torch.dtype, torch.device,
                                   torch.layout, torch.memory_format)):
        return x
    raise _Unkeyed


def _meta_key(func, args, kwargs):
    """A key of ``func`` on its arguments where every tensor among them is a
    ``meta`` tensor (else None)."""
    if func._schema.is_mutable or func.is_view:
        return None
    try:
        return (func, _key_of(args), _key_of(tuple(sorted(kwargs.items()))))
    except _Unkeyed:
        return None


def _group_size(func, args, kwargs) -> int:
    """The size of a collective's group: a c10d op's ``process_group``, a
    functional collective's ``group_name``."""
    import torch.distributed as dist

    for i, a in enumerate(func._schema.arguments):
        if a.name in ("process_group", "group_name"):
            value = args[i] if i < len(args) else kwargs[a.name]
            if isinstance(value, str):
                value = dist.distributed_c10d._resolve_process_group(value)
            elif not isinstance(value, dist.ProcessGroup):
                value = dist.ProcessGroup.unbox(value)  # the op's TorchScript handle
            return value.size()
    raise ValueError(f"{func}: no process group among its arguments")


def count_step(step, *args, values=None, **kwargs):
    """``(step(*args, **kwargs), OpTrace)``: one call counted; ``values``
    as :class:`OpCounter` takes them."""
    counter = OpCounter(values=values)
    with counter:
        out = step(*args, **kwargs)
    return out, counter.close(out)


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------


def _wire_factor(kind: str, group: int) -> float:
    """Per-device wire bytes per output byte, ring algorithms (a copy of
    the reference's ``hlo_analysis._wire_factor``).

    all-reduce: reduce-scatter + all-gather = 2(s-1)/s x size;
    all-gather: (s-1)/s x gathered size; reduce-scatter: (s-1) x scattered
    output (= (s-1)/s x input); all-to-all: (s-1)/s; permute: 1."""
    s = max(2, group)
    return {
        "all-reduce": 2 * (s - 1) / s,
        "all-gather": (s - 1) / s,
        "reduce-scatter": float(s - 1),
        "all-to-all": (s - 1) / s,
        "collective-permute": 1.0,
    }[kind]


def weighted_collective_bytes(trace: OpTrace) -> dict:
    """The counterpart of ``hlo_analysis.weighted_collective_bytes`` over a
    trace: output bytes, counts and per-device wire bytes (the reference's
    ring factors on each collective's group size) by kind, and their
    totals. No trip weighting: the trace holds every collective the step
    issued. A kind outside :data:`COLLECTIVES` (a broadcast, say) has no
    ring factor and counts its output bytes on the wire."""
    out: dict[str, int] = {}
    counts: dict[str, int] = {}
    wire: dict[str, float] = {}
    for kind, nbytes, group in trace.collectives:
        out[kind] = out.get(kind, 0) + nbytes
        counts[kind] = counts.get(kind, 0) + 1
        factor = _wire_factor(kind, group) if kind in COLLECTIVES else 1.0
        wire[kind] = wire.get(kind, 0.0) + nbytes * factor
    return {"bytes": out, "counts": counts, "wire_bytes": {k: int(v) for k, v in wire.items()},
            "total_bytes": sum(out.values()), "total_wire_bytes": int(sum(wire.values()))}
