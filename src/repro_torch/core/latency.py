"""Split-inference latency model — Eqs. (4)-(8) of Jenhani et al. 2025.

The model decomposes end-to-end split-inference latency into

  T_inference(s; r) = T_d(s) + T_tr(s, r)                          (Eq. 8)

where ``s = (s_1, ..., s_{N-1})`` are the split points partitioning an
L-layer model across N devices,

  T_d(s)  = sum_i  T_load_i + T_ta_i + T_infer_i + T_iab_i         (Eq. 4-5)
  T_tr(s) = sum_i  K_{s_i} * ( MTU / (r (1-p)) + T_prop + T_ack )  (Eq. 6-7)
  K_{s_i} = ceil( L_{s_i} / MTU )        (packets for activation bytes)

All times are in **seconds**, all sizes in **bytes**.

This is the port's own copy of ``repro.core.latency``: host-side numpy
arithmetic in the reference's exact operation order (``np.cumsum``
prefix rows, Python ``sum()`` in the scalar queries), so the cost
tensors the port's DP kernels consume are bit-identical to the
reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import cached_property
from typing import Callable, Sequence

import numpy as np

INF = float("inf")

#: Recognized cost channels for the stacked multi-channel tensor export
#: (``segment_cost_tensor(n, channels=...)`` and
#: ``sweep.stack_cost_tensors(..., channels=...)``), in canonical order.
COST_CHANNELS = ("latency", "energy")


# ---------------------------------------------------------------------------
# Profiles
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinkProfile:
    """A (wireless or interconnect) link, per Table I / Eq. 7.

    ``rate_bytes_per_s`` is the serialization rate ``r``; ``loss_p`` the
    packet-loss probability ``p``; ``t_prop_s``/``t_ack_s`` per-packet
    propagation and acknowledgment overheads. ``t_setup_s`` is the one-time
    protocol/session setup and ``t_feedback_s`` the prediction-return delay
    (both enter the RTT, Table IV, not the per-hop Eq. 7).

    ``tx_power_w``/``rx_power_w`` are the radio draw while transmitting /
    receiving; they feed the **energy** cost channel
    (:meth:`SplitCostModel.segment_energy_j`) and default to 0 so
    latency-only profiles are unchanged."""

    name: str
    mtu_bytes: int
    rate_bytes_per_s: float
    loss_p: float = 0.0
    t_prop_s: float = 0.0
    t_ack_s: float = 0.0
    t_setup_s: float = 0.0
    t_feedback_s: float = 0.0
    max_devices: int | None = None
    tx_power_w: float = 0.0
    rx_power_w: float = 0.0

    def packets(self, nbytes: int) -> int:
        """K = ceil(L / MTU) — number of MTU-limited packets (Eq. 7)."""
        if nbytes <= 0:
            return 0
        return math.ceil(nbytes / self.mtu_bytes)

    def packet_time_s(self) -> float:
        """Expected per-packet time: MTU/(r(1-p)) + T_prop + T_ack."""
        return (
            self.mtu_bytes / (self.rate_bytes_per_s * (1.0 - self.loss_p))
            + self.t_prop_s
            + self.t_ack_s
        )

    def transmission_latency_s(self, nbytes: int) -> float:
        """Eq. 7: expected time to move ``nbytes`` across this link."""
        return self.packets(nbytes) * self.packet_time_s()


@dataclass(frozen=True)
class DeviceProfile:
    """A compute device (an IoT node), per Eq. 4 and Table III.

    Device-local latency for a segment holding ``param_bytes`` of weights
    and producing ``act_bytes`` of activations:

      T_load  = t_model_load_s + param_bytes * model_load_s_per_byte
      T_ta    = t_tensor_alloc_s + work_bytes * tensor_alloc_s_per_byte
      T_infer = sum over segment layers of per-layer inference time
                (from the ``ModelCostProfile``) * compute_scale
      T_iab   = t_buffer_s + act_bytes * buffer_s_per_byte

    ``mem_limit_bytes``: hard feasibility budget (SRAM+PSRAM on ESP32-S3,
    device memory of a larger stage). Segments exceeding it cost +inf — this is
    what produces the ResNet50 infeasibility fluctuations in Fig. 3.

    ``active_power_w``: compute draw while the device works on its local
    segment; feeds the energy channel (E_local = P_active * T_local) and
    defaults to 0 so latency-only profiles are unchanged."""

    name: str
    compute_scale: float = 1.0
    t_model_load_s: float = 0.0
    model_load_s_per_byte: float = 0.0
    t_input_load_s: float = 0.0
    t_tensor_alloc_s: float = 0.0
    tensor_alloc_s_per_byte: float = 0.0
    t_buffer_s: float = 0.0
    buffer_s_per_byte: float = 0.0
    mem_limit_bytes: float | None = None
    active_power_w: float = 0.0

    def local_latency_s(
        self,
        infer_s: float,
        param_bytes: int,
        act_bytes: int,
        work_bytes: int,
        is_first: bool = False,
    ) -> float:
        """Eq. 4 for one device; +inf if the segment does not fit."""
        if self.mem_limit_bytes is not None and param_bytes + work_bytes > self.mem_limit_bytes:
            return INF
        t = self.t_model_load_s + param_bytes * self.model_load_s_per_byte
        t += self.t_tensor_alloc_s + work_bytes * self.tensor_alloc_s_per_byte
        t += infer_s * self.compute_scale
        t += self.t_buffer_s + act_bytes * self.buffer_s_per_byte
        if is_first:
            t += self.t_input_load_s
        return t


@dataclass(frozen=True)
class ContentionModel:
    """Shared-channel contention: ``transmitters`` devices time-share one
    physical channel, so each sees ``mac_efficiency / transmitters`` of the
    nominal serialization rate (SplitMAC-style TDMA schedule;
    ``mac_efficiency`` < 1 models MAC/backoff overhead of sharing).

    ``transmitters <= 1`` is the uncontended fast path: :meth:`apply`
    returns the link object **unchanged** (the same object, not a copy), so
    a contention group of size 1 is bit-identical to no contention model at
    all — the property suite pins this."""

    transmitters: int = 1
    mac_efficiency: float = 1.0

    def __post_init__(self):
        if self.transmitters < 1:
            raise ValueError(f"transmitters must be >= 1, got {self.transmitters}")
        if not (0.0 < self.mac_efficiency <= 1.0):
            raise ValueError(
                f"mac_efficiency must be in (0, 1], got {self.mac_efficiency}")

    def rate_scale(self) -> float:
        """Fraction of the nominal rate each transmitter sees (1.0 alone)."""
        if self.transmitters <= 1:
            return 1.0
        return self.mac_efficiency / self.transmitters

    def apply(self, link: LinkProfile) -> LinkProfile:
        """Effective link under this schedule; the *same* object at scale 1."""
        scale = self.rate_scale()
        if scale == 1.0:
            return link
        return replace(link, rate_bytes_per_s=link.rate_bytes_per_s * scale)


@dataclass(frozen=True)
class BottleneckVariant:
    """One bottleneck-compression variant of a model (the COMSPLIT /
    NAS-for-split-computing axis): a learned encoder at the cut shrinks
    the activation payload by ``compression_factor`` at the price of
    extra sensor-side compute (the encoder) and a lower
    ``accuracy_proxy``. The decision variable of the planners grows from
    "split point" to "(split point, variant)".

    Semantics at a cut carrying ``nbytes`` of raw activation:

    * the radio moves :meth:`compressed_bytes` ``= ceil(nbytes /
      compression_factor)`` bytes (packetized per Eq. 7 as usual);
    * the transmitting device first spends :meth:`encoder_time_s`
      ``= encoder_t_s + nbytes * encoder_s_per_byte`` running the
      encoder (charged as latency on the cut and as
      ``active_power_w * encoder_time`` on the energy channel);
    * the device-local segment cost is otherwise UNCHANGED — the output
      buffer still holds the raw activation (the encoder reads it), so
      the device-local cost tensor stays variant-independent and the
      fused ``local + TX`` decomposition of the fused DP kernel
      survives: compression and encoder time ride entirely in the
      per-cut transmission vector.

    ``accuracy_proxy`` is a unitless relative-accuracy column (1.0 for
    the identity variant); it never enters the latency/energy arithmetic
    and exists for Pareto-frontier emission and accuracy-floor masking
    (``min latency s.t. accuracy_proxy >= floor``).

    The identity variant (factor 1, no encoder cost) is the degenerate
    fast path: every consumer treats it exactly like "no variant", so
    single-variant runs are bit-identical to the historical outputs —
    the property suite pins this."""

    name: str = "identity"
    compression_factor: float = 1.0
    encoder_t_s: float = 0.0
    encoder_s_per_byte: float = 0.0
    accuracy_proxy: float = 1.0

    def __post_init__(self):
        if not self.compression_factor >= 1.0:
            raise ValueError(
                f"compression_factor must be >= 1, got {self.compression_factor}")
        if self.encoder_t_s < 0.0 or self.encoder_s_per_byte < 0.0:
            raise ValueError("encoder costs must be >= 0")
        if not self.accuracy_proxy >= 0.0:
            raise ValueError(
                f"accuracy_proxy must be >= 0, got {self.accuracy_proxy}")

    @property
    def is_identity(self) -> bool:
        """True when this variant changes nothing (the degenerate path)."""
        return (self.compression_factor == 1.0
                and self.encoder_t_s == 0.0
                and self.encoder_s_per_byte == 0.0)

    def compressed_bytes(self, nbytes: int) -> int:
        """Payload bytes the radio actually moves for ``nbytes`` of raw
        activation at the cut."""
        if nbytes <= 0 or self.compression_factor == 1.0:
            return int(nbytes)
        return math.ceil(nbytes / self.compression_factor)

    def encoder_time_s(self, nbytes: int) -> float:
        """Sensor-side encoder latency for ``nbytes`` of raw activation
        (0 when nothing crosses the cut)."""
        if nbytes <= 0:
            return 0.0
        return self.encoder_t_s + nbytes * self.encoder_s_per_byte


#: The degenerate no-op variant (factor 1, free encoder, accuracy 1.0).
IDENTITY_VARIANT = BottleneckVariant()


def bottleneck_variant(
    compression_factor: float,
    *,
    encoder_t_s: float = 0.0,
    encoder_s_per_byte: float = 0.0,
    accuracy_drop_per_octave: float = 0.03,
    name: str | None = None,
) -> BottleneckVariant:
    """Build one :class:`BottleneckVariant` from a compression factor.

    The encoder cost and accuracy drop both scale with the bottleneck
    *depth* ``log2(compression_factor)``: each halving of the payload
    adds one encoder stage (``encoder_t_s``/``encoder_s_per_byte`` are
    per-octave rates) and costs ``accuracy_drop_per_octave`` of relative
    accuracy (floored at 0). A factor of 1 yields the exact
    :data:`IDENTITY_VARIANT` semantics (zero encoder cost, accuracy
    1.0)."""
    if not compression_factor >= 1.0:
        raise ValueError(
            f"compression_factor must be >= 1, got {compression_factor}")
    octaves = math.log2(compression_factor)
    return BottleneckVariant(
        name=name or ("identity" if compression_factor == 1.0
                      else f"cx{compression_factor:g}"),
        compression_factor=compression_factor,
        encoder_t_s=encoder_t_s * octaves,
        encoder_s_per_byte=encoder_s_per_byte * octaves,
        accuracy_proxy=max(0.0, 1.0 - accuracy_drop_per_octave * octaves),
    )


def bottleneck_variants(
    compression_factors: Sequence[float], **kwargs
) -> tuple[BottleneckVariant, ...]:
    """A variant bank: one :func:`bottleneck_variant` per factor."""
    return tuple(bottleneck_variant(f, **kwargs) for f in compression_factors)


@dataclass(frozen=True)
class LayerCost:
    """Static per-layer cost record (one node of the sequential chain Eq. 1)."""

    name: str
    t_infer_s: float  # inference time on the reference device (compute_scale=1)
    act_bytes: int  # bytes of the layer's output activation (the tensor crossing a cut here)
    param_bytes: int  # weight bytes attributable to this layer
    work_bytes: int = 0  # peak working-set bytes while executing this layer
    flops: float = 0.0  # arithmetic work (used by analytic profiles)


@dataclass(frozen=True)
class ModelCostProfile:
    """The per-layer cost table the planner consumes (the paper's 'measured
    per-layer inference and transmission costs')."""

    name: str
    layers: tuple[LayerCost, ...]
    input_bytes: int = 0

    def __post_init__(self):
        object.__setattr__(self, "layers", tuple(self.layers))

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    # -- prefix sums for O(1) segment queries ------------------------------
    def _prefix(self, key: Callable[[LayerCost], float]) -> list[float]:
        cache_name = f"_prefix_{id(key)}"
        out = [0.0]
        for lc in self.layers:
            out.append(out[-1] + key(lc))
        return out

    def segment_infer_s(self, a: int, b: int) -> float:
        """Sum of per-layer inference times for layers [a, b] (1-indexed inclusive)."""
        return sum(lc.t_infer_s for lc in self.layers[a - 1 : b])

    def segment_param_bytes(self, a: int, b: int) -> int:
        return sum(lc.param_bytes for lc in self.layers[a - 1 : b])

    def segment_work_bytes(self, a: int, b: int) -> int:
        seg = self.layers[a - 1 : b]
        return max((lc.work_bytes for lc in seg), default=0)

    def segment_flops(self, a: int, b: int) -> float:
        return sum(lc.flops for lc in self.layers[a - 1 : b])

    def boundary_act_bytes(self, b: int) -> int:
        """Bytes crossing a cut after layer ``b`` (1-indexed); 0 at b=0/L."""
        if b <= 0:
            return self.input_bytes
        if b >= self.num_layers:
            return 0
        return self.layers[b - 1].act_bytes

    # -- dense per-segment arrays (vectorized planning / sweep engine) ------
    @cached_property
    def segment_arrays(self) -> "SegmentArrays":
        """Dense segment-cost arrays; entry ``[a-1, b-1]`` covers layers
        ``[a, b]`` (1-indexed inclusive), lower triangle (a > b) is 0/unused.

        Bit-exactness contract: row-wise ``np.cumsum`` accumulates
        left-to-right exactly like the Python ``sum`` in
        :meth:`segment_infer_s`, so every upper-triangle entry equals the
        scalar query bit-for-bit. This is what lets the batched solvers in
        :mod:`repro_torch.core.sweep` certify against the scalar oracle."""
        L = self.num_layers
        t_infer = np.array([lc.t_infer_s for lc in self.layers], dtype=np.float64)
        p_bytes = np.array([lc.param_bytes for lc in self.layers], dtype=np.int64)
        w_bytes = np.array([lc.work_bytes for lc in self.layers], dtype=np.int64)
        flops = np.array([lc.flops for lc in self.layers], dtype=np.float64)

        infer = np.zeros((L, L), dtype=np.float64)
        param = np.zeros((L, L), dtype=np.int64)
        work = np.zeros((L, L), dtype=np.int64)
        fl = np.zeros((L, L), dtype=np.float64)
        for a in range(L):
            infer[a, a:] = np.cumsum(t_infer[a:])
            param[a, a:] = np.cumsum(p_bytes[a:])
            work[a, a:] = np.maximum.accumulate(w_bytes[a:])
            fl[a, a:] = np.cumsum(flops[a:])

        boundary = np.zeros(L + 1, dtype=np.int64)
        boundary[0] = self.input_bytes
        if L > 1:
            boundary[1:L] = np.array(
                [lc.act_bytes for lc in self.layers[: L - 1]], dtype=np.int64
            )
        return SegmentArrays(
            infer_s=infer, param_bytes=param, work_bytes=work, flops=fl,
            boundary_act_bytes=boundary,
        )


@dataclass(frozen=True)
class SegmentArrays:
    """Dense 0-indexed segment arrays exported by
    :attr:`ModelCostProfile.segment_arrays` (see its docstring for the
    indexing and bit-exactness contract)."""

    infer_s: np.ndarray  # (L, L) float64, [a-1, b-1] = sum of t_infer over [a, b]
    param_bytes: np.ndarray  # (L, L) int64
    work_bytes: np.ndarray  # (L, L) int64 (max over the segment)
    flops: np.ndarray  # (L, L) float64
    boundary_act_bytes: np.ndarray  # (L+1,) int64; [b] = bytes crossing the cut after layer b


# ---------------------------------------------------------------------------
# Segment and end-to-end cost (Eq. 8 and CostSegment of Alg. 1-3)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SplitCostModel:
    """Binds a ``ModelCostProfile`` to device and link profiles and exposes
    ``CostSegment(a, b, k)`` (Alg. 1-3) and the end-to-end objective (Eq. 8).

    ``objective``:
      * ``"sum"``        — paper-faithful Eq. 5: total latency is the sum of
                           all device-local and transmission latencies
                           (single request traversing the chain).
      * ``"bottleneck"`` — steady-state pipeline throughput: the slowest
                           stage (compute+transmit) bounds the system; used
                           by pipeline planning.

    ``contention``: optional shared-channel schedule; when set, every
    transmission price (latency *and* energy) uses
    :attr:`effective_link` — the nominal link with its rate scaled by
    :meth:`ContentionModel.rate_scale`. ``None`` (and a group of size 1)
    is bit-identical to the historical uncontended path.

    ``variant``: optional :class:`BottleneckVariant`. When set, every
    cut prices the *compressed* payload (airtime at
    :meth:`BottleneckVariant.compressed_bytes`) plus the sensor-side
    encoder time; the energy channel adds ``active_power_w *
    encoder_time`` on the transmitting device and radio airtimes shrink
    with the payload. Device-local segment costs are untouched (the
    output buffer holds the raw activation the encoder reads), so
    :meth:`local_cost_tensor` is variant-independent and the sweep
    engine's fused ``local + TX`` decomposition survives. ``None`` and
    the identity variant are bit-identical to the historical path.
    """

    profile: ModelCostProfile
    devices: Sequence[DeviceProfile]
    link: LinkProfile
    objective: str = "sum"
    include_setup: bool = False  # add per-hop link setup into segment costs
    contention: ContentionModel | None = None
    variant: BottleneckVariant | None = None

    def __post_init__(self):
        if self.objective not in ("sum", "bottleneck"):
            raise ValueError(f"unknown objective {self.objective!r}")

    @property
    def effective_link(self) -> LinkProfile:
        """The link every transmission price sees (contention applied).

        With ``contention=None`` (or a size-1 group) this is ``self.link``
        itself — the identical object — so the default path is bit-exact."""
        if self.contention is None:
            return self.link
        return self.contention.apply(self.link)

    @property
    def _active_variant(self) -> BottleneckVariant | None:
        """The variant when it changes anything; None for the identity
        (so every degenerate path takes the exact historical code)."""
        v = self.variant
        if v is None or v.is_identity:
            return None
        return v

    def cut_payload_bytes(self, b: int) -> int:
        """Bytes actually crossing the cut after layer ``b`` — the
        variant-compressed payload (raw boundary bytes without one)."""
        act = self.profile.boundary_act_bytes(b)
        v = self._active_variant
        return act if v is None else v.compressed_bytes(act)

    def cut_cost_s(self, b: int) -> float:
        """Latency charged at the cut after layer ``b``, excluding
        per-hop setup: airtime of the (variant-compressed) payload plus
        the variant's encoder time. 0 outside ``1 <= b < L``."""
        if not 1 <= b < self.profile.num_layers:
            return 0.0
        link = self.effective_link
        act = self.profile.boundary_act_bytes(b)
        v = self._active_variant
        if v is None:
            return link.transmission_latency_s(act)
        return (link.transmission_latency_s(v.compressed_bytes(act))
                + v.encoder_time_s(act))

    def device(self, k: int) -> DeviceProfile:
        """Device executing segment k (1-indexed). A single profile may be
        broadcast over any N."""
        if len(self.devices) == 1:
            return self.devices[0]
        return self.devices[k - 1]

    # -- CostSegment(a, b, k): layers [a..b] on device k --------------------
    def segment_cost_s(self, a: int, b: int, k: int, *, n_devices: int | None = None) -> float:
        """Latency contribution of assigning layers [a, b] to device k,
        'including both local inference and transmission costs' (Sec. IV-B).

        Transmission is charged for the activation leaving layer ``b``
        unless ``b == L`` (the prediction return is the link feedback delay,
        charged once in ``end_to_end_s``)."""
        prof = self.profile
        L = prof.num_layers
        if not (1 <= a <= b <= L):
            return INF
        dev = self.device(k)
        local = dev.local_latency_s(
            infer_s=prof.segment_infer_s(a, b),
            param_bytes=prof.segment_param_bytes(a, b),
            act_bytes=prof.boundary_act_bytes(b),
            work_bytes=prof.segment_work_bytes(a, b),
            is_first=(k == 1),
        )
        if local == INF:
            return INF
        tx = 0.0
        if b < L:
            link = self.effective_link
            act = prof.boundary_act_bytes(b)
            v = self._active_variant
            if v is None:
                tx = link.transmission_latency_s(act)
            else:
                tx = link.transmission_latency_s(v.compressed_bytes(act))
            if self.include_setup:
                tx += link.t_setup_s
            if v is not None:
                tx += v.encoder_time_s(act)
        return local + tx

    # -- energy channel: Joules for CostSegment(a, b, k) --------------------
    def segment_energy_j(self, a: int, b: int, k: int, *, n_devices: int | None = None) -> float:
        """Energy (Joules) of assigning layers [a, b] to device k:

          E = P_active * T_local + P_tx * T_tx(out) + P_rx * T_rx(in)

        where T_tx prices the activation leaving layer ``b`` (0 at b = L)
        and T_rx the activation *entering* at the cut after layer ``a - 1``
        (0 for the head device, which loads the input locally). Airtime
        uses the contention-scaled :attr:`effective_link`; per-hop setup is
        never charged (it is a latency, not a radio-on interval). +inf
        mirrors :meth:`segment_cost_s` infeasibility exactly."""
        prof = self.profile
        L = prof.num_layers
        if not (1 <= a <= b <= L):
            return INF
        dev = self.device(k)
        local = dev.local_latency_s(
            infer_s=prof.segment_infer_s(a, b),
            param_bytes=prof.segment_param_bytes(a, b),
            act_bytes=prof.boundary_act_bytes(b),
            work_bytes=prof.segment_work_bytes(a, b),
            is_first=(k == 1),
        )
        if local == INF:
            return INF
        link = self.effective_link
        v = self._active_variant
        e = dev.active_power_w * local
        if v is not None and b < L:
            # the transmitting device runs the bottleneck encoder at
            # compute draw before the radio turns on
            e = e + dev.active_power_w * v.encoder_time_s(prof.boundary_act_bytes(b))
        e = e + link.tx_power_w * (
            link.transmission_latency_s(self.cut_payload_bytes(b)) if b < L else 0.0
        )
        e = e + link.rx_power_w * (
            link.transmission_latency_s(self.cut_payload_bytes(a - 1)) if a > 1 else 0.0
        )
        return e

    def energy_segment_fn(self) -> Callable[[int, int, int], float]:
        """The per-segment energy callable consumed by the scalar solvers
        (``energy_fn=`` of the scalar solvers)."""
        return self.segment_energy_j

    # -- Eq. 8 over a full configuration ------------------------------------
    def end_to_end_s(self, splits: Sequence[int], *, with_overheads: bool = True) -> float:
        """T_inference(s; r) for split points ``splits = (s_1..s_{N-1})``.

        ``with_overheads`` adds the one-time protocol setup and the
        prediction feedback delay (the Table-IV RTT decomposition)."""
        L = self.profile.num_layers
        bounds = [0, *splits, L]
        n = len(bounds) - 1
        for i in range(n):
            if not bounds[i] < bounds[i + 1]:
                return INF
        seg_costs = [
            self.segment_cost_s(bounds[i] + 1, bounds[i + 1], i + 1, n_devices=n)
            for i in range(n)
        ]
        if any(c == INF for c in seg_costs):
            return INF
        if self.objective == "bottleneck":
            total = max(seg_costs)
        else:
            total = sum(seg_costs)
        if with_overheads:
            link = self.effective_link
            total += link.t_setup_s + link.t_feedback_s
        return total

    def cost_segment_fn(self) -> Callable[[int, int, int], float]:
        """The ``CostSegment`` callable consumed by the solvers."""
        return self.segment_cost_s

    # -- dense tensor export (the sweep-engine fast path) --------------------
    def _local_cost_matrix(self, dev: DeviceProfile, is_first: bool) -> np.ndarray:
        """(L, L) float64 of device-local latency for every segment [a, b]
        on ``dev``; +inf where the segment is invalid (a > b) or does not
        fit memory. Mirrors :meth:`DeviceProfile.local_latency_s` operation
        by operation so entries are bit-identical to the scalar path."""
        seg = self.profile.segment_arrays
        L = self.profile.num_layers
        act = seg.boundary_act_bytes[1:]  # [b-1] = bytes leaving layer b (0 at b=L)
        t = dev.t_model_load_s + seg.param_bytes * dev.model_load_s_per_byte
        t = t + (dev.t_tensor_alloc_s + seg.work_bytes * dev.tensor_alloc_s_per_byte)
        t = t + seg.infer_s * dev.compute_scale
        t = t + (dev.t_buffer_s + act[None, :] * dev.buffer_s_per_byte)
        if is_first:
            t = t + dev.t_input_load_s
        invalid = np.tril(np.ones((L, L), dtype=bool), k=-1)  # a > b
        if dev.mem_limit_bytes is not None:
            invalid |= (seg.param_bytes + seg.work_bytes) > dev.mem_limit_bytes
        return np.where(invalid, INF, t)

    def _tx_time_vector(self) -> np.ndarray:
        """(L,) float64 raw expected airtime: ``[b-1]`` = time on the
        (contention-scaled) link for the activation leaving layer ``b``
        (0 at b = L). No setup — this is the radio-on interval shared by
        the latency and energy channels."""
        seg = self.profile.segment_arrays
        link = self.effective_link
        act = seg.boundary_act_bytes[1:].astype(np.float64)
        v = self._active_variant
        if v is not None:
            # same ceil arithmetic as BottleneckVariant.compressed_bytes,
            # so packet counts match the scalar path bit-for-bit
            act = np.where(act > 0, np.ceil(act / v.compression_factor), 0.0)
        packets = np.where(act > 0, np.ceil(act / link.mtu_bytes), 0.0)
        tx = packets * link.packet_time_s()
        tx[-1] = 0.0  # no transmission after the final layer
        return tx

    def _encoder_time_vector(self) -> np.ndarray:
        """(L,) float64; ``[b-1]`` = variant encoder time for the raw
        activation leaving layer ``b`` (all zeros without a variant;
        0 at b = L). Mirrors :meth:`BottleneckVariant.encoder_time_s`."""
        L = self.profile.num_layers
        v = self._active_variant
        if v is None:
            return np.zeros(L, dtype=np.float64)
        act = self.profile.segment_arrays.boundary_act_bytes[1:].astype(np.float64)
        enc = np.where(act > 0, v.encoder_t_s + act * v.encoder_s_per_byte, 0.0)
        enc[-1] = 0.0
        return enc

    def transmission_cost_vector(self) -> np.ndarray:
        """(L,) float64; ``[b-1]`` = link cost charged when cutting after
        layer ``b`` (0 at b = L). Identical arithmetic to
        :meth:`LinkProfile.transmission_latency_s` (+ setup when
        ``include_setup``); with a variant, airtime prices the
        compressed payload and the encoder time is added last, matching
        :meth:`segment_cost_s` operation order."""
        tx = self._tx_time_vector()
        if self.include_setup:
            tx = tx + self.effective_link.t_setup_s  # charged on every cut (b < L)
            tx[-1] = 0.0
        if self._active_variant is not None:
            tx = tx + self._encoder_time_vector()
        return tx

    def local_cost_tensor(self, n_devices: int) -> np.ndarray:
        """(N, L, L) float64 of device-local segment costs, ``[k-1, a-1,
        b-1]`` = local part of ``segment_cost_s(a, b, k)``."""
        L = self.profile.num_layers
        out = np.empty((n_devices, L, L), dtype=np.float64)
        out[0] = self._local_cost_matrix(self.device(1), is_first=True)
        generic: np.ndarray | None = None
        for k in range(2, n_devices + 1):
            if len(self.devices) == 1:
                if generic is None:
                    generic = self._local_cost_matrix(self.devices[0], is_first=False)
                out[k - 1] = generic
            else:
                out[k - 1] = self._local_cost_matrix(self.device(k), is_first=False)
        return out

    def segment_cost_tensor(
        self, n_devices: int, channels: Sequence[str] | None = None
    ) -> np.ndarray:
        """Dense ``C[k-1, a-1, b-1] == segment_cost_s(a, b, k)`` tensor of
        shape (N, L, L), float64, +inf at invalid/infeasible segments.

        Entries are bit-identical to the scalar per-call path — the
        batched solvers in :mod:`repro_torch.core.sweep` consume these tensors
        and certify their results against the scalar oracle.

        ``channels``: optional sequence drawn from :data:`COST_CHANNELS`
        (``"latency"``, ``"energy"``). When given, returns a stacked
        ``C[ch, k-1, a-1, b-1]`` tensor of shape (len(channels), N, L, L);
        each channel slice is bit-identical to the corresponding
        single-channel export (``segment_cost_tensor(n)`` /
        :meth:`energy_cost_tensor`)."""
        if channels is not None:
            return np.stack(
                [self._channel_tensor(ch, n_devices) for ch in channels]
            )
        local = self.local_cost_tensor(n_devices)
        tx = self.transmission_cost_vector()
        return local + tx[None, None, :]

    def energy_cost_tensor(self, n_devices: int) -> np.ndarray:
        """Dense ``E[k-1, a-1, b-1] == segment_energy_j(a, b, k)`` tensor
        of shape (N, L, L) Joules, +inf exactly where the latency tensor is
        +inf. Mirrors :meth:`segment_energy_j` operation by operation
        (power * airtime, tx then rx) so entries are bit-identical to the
        scalar path."""
        L = self.profile.num_layers
        local = self.local_cost_tensor(n_devices)
        power = np.array(
            [self.device(k).active_power_w for k in range(1, n_devices + 1)],
            dtype=np.float64,
        )
        with np.errstate(invalid="ignore"):
            e = np.where(np.isfinite(local), power[:, None, None] * local, INF)
        link = self.effective_link
        if self._active_variant is not None:
            # encoder energy on the transmitting device, in the same
            # position as the scalar path (after P*local, before radio)
            enc = self._encoder_time_vector()
            e = e + power[:, None, None] * enc[None, None, :]
        tx_t = self._tx_time_vector()  # [b-1] = airtime of the cut after b
        rx_t = np.zeros(L, dtype=np.float64)
        rx_t[1:] = tx_t[: L - 1]  # [a-1] = airtime of the cut entering at a
        e = e + (link.tx_power_w * tx_t)[None, None, :]
        e = e + (link.rx_power_w * rx_t)[None, :, None]
        return e

    def _channel_tensor(self, channel: str, n_devices: int) -> np.ndarray:
        if channel == "latency":
            return self.segment_cost_tensor(n_devices)
        if channel == "energy":
            return self.energy_cost_tensor(n_devices)
        raise ValueError(
            f"unknown cost channel {channel!r}; expected one of {COST_CHANNELS}")


# ---------------------------------------------------------------------------
# RTT decomposition (Table III / IV reproduction)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RTTBreakdown:
    setup_s: float
    device_s: tuple[float, ...]
    transmission_s: tuple[float, ...]
    feedback_s: float

    @property
    def rtt_s(self) -> float:
        return self.setup_s + sum(self.device_s) + sum(self.transmission_s) + self.feedback_s


def rtt_breakdown(model: SplitCostModel, splits: Sequence[int]) -> RTTBreakdown:
    """Full RTT decomposition for a split configuration (Tables III-IV)."""
    prof = model.profile
    L = prof.num_layers
    link = model.effective_link
    bounds = [0, *splits, L]
    n = len(bounds) - 1
    dev_times, tx_times = [], []
    for i in range(n):
        a, b, k = bounds[i] + 1, bounds[i + 1], i + 1
        dev = model.device(k)
        dev_times.append(
            dev.local_latency_s(
                infer_s=prof.segment_infer_s(a, b),
                param_bytes=prof.segment_param_bytes(a, b),
                act_bytes=prof.boundary_act_bytes(b),
                work_bytes=prof.segment_work_bytes(a, b),
                is_first=(k == 1),
            )
        )
        if b < L:
            # cut_cost_s prices the variant-compressed payload + encoder
            # (bit-identical to the raw airtime without a variant)
            tx_times.append(model.cut_cost_s(b))
    return RTTBreakdown(
        setup_s=link.t_setup_s,
        device_s=tuple(dev_times),
        transmission_s=tuple(tx_times),
        feedback_s=link.t_feedback_s,
    )


def scale_profile(profile: ModelCostProfile, infer_total_s: float) -> ModelCostProfile:
    """Rescale per-layer inference times so they sum to ``infer_total_s``
    (used to calibrate analytic FLOP-proportional tables to a measured
    end-to-end inference time, Table III)."""
    cur = sum(lc.t_infer_s for lc in profile.layers)
    if cur <= 0:
        raise ValueError("profile has no inference time to scale")
    f = infer_total_s / cur
    return replace(
        profile,
        layers=tuple(replace(lc, t_infer_s=lc.t_infer_s * f) for lc in profile.layers),
    )
