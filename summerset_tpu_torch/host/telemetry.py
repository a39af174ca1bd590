"""Host metrics registry: counters, gauges, power-of-two histograms,
counterpart of ``MetricsRegistry`` in ``summerset_tpu/host/telemetry.py``.

One registry per server, threaded through every hub seam as
``registry=``: ``ExternalApi`` (request latency, shed counts),
``TransportHub`` (frames and bytes per peer), ``StorageHub`` (fsync
latency, group-commit batch size) and ``ServerReplica`` (the
``loop_stage_us{stage=...}`` run-loop histograms, which are how a serving
tick's time on the card is read).

Histogram buckets: bucket ``i`` holds samples with ``bit_length == i``
(bounds 1, 2, 4, ...), with count/sum/min/max; ``since`` gives the
samples of a window.  The JAX registry's snapshot and quantiles, slot
traces, the flight recorder and the streaming watch plane are not
ported yet.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_NB = 64


def _key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Histogram:
    """Exponential (power-of-two) bucket histogram over integer samples."""

    __slots__ = ("count", "total", "vmin", "vmax", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0
        self.vmin: Optional[int] = None
        self.vmax = 0
        self.buckets = [0] * _NB

    def observe(self, value) -> None:
        v = max(0, int(value))
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self.buckets[min(v.bit_length(), _NB - 1)] += 1

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def since(self, prev: Optional["Histogram"]) -> "Histogram":
        """The samples recorded after ``prev`` was copied (min/max stay
        the cumulative ones: they are not delta-decodable)."""
        if prev is None:
            return self
        out = Histogram()
        out.count = self.count - prev.count
        out.total = self.total - prev.total
        out.vmin = self.vmin
        out.vmax = self.vmax
        out.buckets = [a - b for a, b in zip(self.buckets, prev.buckets)]
        return out

    def copy(self) -> "Histogram":
        out = Histogram()
        out.count = self.count
        out.total = self.total
        out.vmin = self.vmin
        out.vmax = self.vmax
        out.buckets = list(self.buckets)
        return out


class MetricsRegistry:
    """Thread-safe named metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- write side (hub seams) ---------------------------------------------
    def counter_add(self, name: str, inc: int = 1, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + int(inc)

    def gauge_set(self, name: str, value, **labels) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def observe(self, name: str, value, **labels) -> None:
        """Record one histogram sample (integer units: us / bytes / n)."""
        k = _key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = Histogram()
            h.observe(value)

    def observe_s(self, name: str, seconds: float, **labels) -> None:
        """Record a latency sample given in seconds (stored as us)."""
        self.observe(name, int(seconds * 1e6), **labels)

    # -- read side -----------------------------------------------------------
    def hist(self, name: str, **labels) -> Optional[Histogram]:
        return self._hists.get(_key(name, labels))

    def counter_value(self, name: str, **labels) -> int:
        return self._counters.get(_key(name, labels), 0)

    def gauge_value(self, name: str, default: float = 0.0, **labels):
        with self._lock:
            return self._gauges.get(_key(name, labels), default)
