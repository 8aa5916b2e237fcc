"""QoS telemetry primitives for the serving gateway.

The port's copy of ``repro.runtime.stats`` (pure Python, no device).

Pure-Python, allocation-light building blocks the
:mod:`repro_torch.runtime.gateway` layers over thousands of concurrent
sessions:

* :func:`percentile` — linear-interpolation percentile identical to
  ``np.percentile(..., method="linear")`` (the default), so fleet p50/p99
  numbers are directly comparable to any NumPy-side analysis and the
  parity is unit-tested against the NumPy oracle.
* :class:`RollingWindow` — a fixed-size ring buffer of floats: O(1)
  ``add``, percentiles over the last ``maxlen`` samples. Bounded by
  construction, so 10k sessions cannot grow memory without bound.
* :class:`QosMonitor` — per-key rolling latency windows plus one
  fleet-global window and a set of monotonic counters; the gateway keys
  windows by session id and aggregates snapshots from here.

Snapshots (:class:`SessionSnapshot` / :class:`FleetSnapshot`) are frozen
value objects: safe to hand to logging/export threads while serving
continues.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field
from typing import Hashable, Iterable, Mapping, Sequence

__all__ = [
    "FleetSnapshot",
    "QosMonitor",
    "RollingWindow",
    "SessionSnapshot",
    "percentile",
]


def percentile(values: Iterable[float], q: float) -> float:
    """The ``q``-th percentile of ``values`` by linear interpolation —
    the same estimator as ``np.percentile(values, q)`` with the default
    ``method="linear"``: rank ``(n-1) * q/100`` with fractional part
    ``t`` interpolated as ``lo + (hi - lo) * t`` (NumPy's lerp form, so
    the parity test can assert exact equality, not approx)."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of an empty sequence")
    if len(xs) == 1:
        return xs[0]
    rank = (len(xs) - 1) * (q / 100.0)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    if lo == hi:
        return xs[lo]
    t = rank - lo
    return xs[lo] + (xs[hi] - xs[lo]) * t


class RollingWindow:
    """Fixed-size ring buffer of float samples.

    ``add`` is O(1); ``count`` is the LIFETIME number of samples (it
    keeps growing past ``maxlen``), while percentiles/mean cover only
    the retained last-``maxlen`` window."""

    __slots__ = ("maxlen", "count", "_buf")

    def __init__(self, maxlen: int = 256):
        if maxlen <= 0:
            raise ValueError(f"maxlen must be positive, got {maxlen}")
        self.maxlen = maxlen
        self.count = 0
        self._buf: list[float] = []

    def add(self, value: float) -> None:
        v = float(value)
        if len(self._buf) < self.maxlen:
            self._buf.append(v)
        else:
            self._buf[self.count % self.maxlen] = v
        self.count += 1

    def __len__(self) -> int:
        return len(self._buf)

    def values(self) -> tuple[float, ...]:
        """The retained samples (arbitrary order — fine for order
        statistics)."""
        return tuple(self._buf)

    def mean(self) -> float:
        if not self._buf:
            raise ValueError("mean of an empty window")
        return sum(self._buf) / len(self._buf)

    def percentile(self, q: float) -> float:
        return percentile(self._buf, q)

    def percentiles(self, qs: Sequence[float] = (50.0, 99.0)
                    ) -> tuple[float, ...]:
        xs = sorted(self._buf)
        if not xs:
            raise ValueError("percentiles of an empty window")
        out = []
        for q in qs:
            if not 0.0 <= q <= 100.0:
                raise ValueError(f"percentile q must be in [0, 100], got {q}")
            rank = (len(xs) - 1) * (q / 100.0)
            lo, hi = math.floor(rank), math.ceil(rank)
            out.append(xs[lo] if lo == hi
                       else xs[lo] + (xs[hi] - xs[lo]) * (rank - lo))
        return tuple(out)


@dataclass(frozen=True)
class SessionSnapshot:
    """One session's QoS at snapshot time: rolling observe-latency
    percentiles plus the adaptive-layer counters
    (:meth:`repro_torch.core.adaptive.AdaptiveSplitManager.counters`)."""

    session_id: str
    n_devices: int
    observes: int
    p50_s: float
    p99_s: float
    counters: Mapping[str, int] = field(default_factory=dict)


@dataclass(frozen=True)
class FleetSnapshot:
    """Fleet-wide QoS at snapshot time. ``counters`` merges the
    gateway's own counters (events/shedding/builds) with the summed
    per-session adaptive counters; percentiles come from the global
    rolling window (NaN when nothing was recorded yet)."""

    seq: int
    n_sessions: int
    observes: int
    p50_s: float
    p99_s: float
    counters: Mapping[str, int] = field(default_factory=dict)
    sessions: tuple[SessionSnapshot, ...] = ()


class QosMonitor:
    """Per-key rolling latency windows + one global window + counters.

    The gateway records every processed observe's wall time under its
    session id; ``drop`` releases a departed session's window (bounded
    memory under churn). Counters are a plain :class:`collections.Counter`
    — monotonic, aggregatable, JSON-friendly."""

    def __init__(self, key_window: int = 256, global_window: int = 8192):
        self.key_window = key_window
        self._windows: dict[Hashable, RollingWindow] = {}
        self.global_window = RollingWindow(global_window)
        self.counters: Counter[str] = Counter()

    def record(self, key: Hashable, seconds: float) -> None:
        w = self._windows.get(key)
        if w is None:
            w = self._windows[key] = RollingWindow(self.key_window)
        w.add(seconds)
        self.global_window.add(seconds)

    def bump(self, name: str, k: int = 1) -> None:
        self.counters[name] += k

    def drop(self, key: Hashable) -> None:
        self._windows.pop(key, None)

    def window(self, key: Hashable) -> RollingWindow | None:
        return self._windows.get(key)

    def key_percentiles(self, key: Hashable,
                        qs: Sequence[float] = (50.0, 99.0)
                        ) -> tuple[float, ...]:
        w = self._windows.get(key)
        if w is None or not len(w):
            return tuple(float("nan") for _ in qs)
        return w.percentiles(qs)

    def fleet_percentiles(self, qs: Sequence[float] = (50.0, 99.0)
                          ) -> tuple[float, ...]:
        if not len(self.global_window):
            return tuple(float("nan") for _ in qs)
        return self.global_window.percentiles(qs)
