"""Metrics registry: counters, gauges, log-bucketed latency histograms.

Complements the span tracer: the tracer answers "what overlapped with
what", these answer "how many / how much / what distribution" at a cost
low enough for per-batch paths (one lock + a couple of integer ops per
observation).  Everything rolls up into a single nested ``snapshot()``
tree keyed by dotted metric names, suitable for dumping next to a bench
JSON artifact.
"""

from __future__ import annotations

import math
import threading


class Counter:
    """Monotonic counter (events, bytes, cache hits)."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int | float:
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins scalar, with optional min/max tracking across the
    values it has held (the resource sampler reports rss peak this way)."""

    __slots__ = ("_lock", "_value", "_min", "_max", "_count")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._count = 0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value
            self._count += 1
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        with self._lock:
            if self._count == 0:
                return {"value": 0.0, "min": 0.0, "max": 0.0, "samples": 0}
            return {
                "value": self._value, "min": self._min, "max": self._max,
                "samples": self._count,
            }


class Histogram:
    """Log-bucketed histogram with quantile estimates.

    Buckets are geometric: bucket ``i`` covers
    ``[base * growth**i, base * growth**(i+1))``, plus an underflow
    bucket below ``base``.  With the defaults (1 µs base, ×2 growth, 64
    buckets) one histogram spans 1 µs .. ~5 hours of latency in 64 ints,
    and a quantile estimate is within a factor of ``growth`` of exact —
    the standard HDR-style trade.  ``merge`` combines per-thread
    histograms recorded without shared locks.
    """

    __slots__ = ("_lock", "base", "growth", "counts", "_count", "_sum",
                 "_min", "_max", "_log_growth")

    def __init__(self, base: float = 1e-6, growth: float = 2.0,
                 num_buckets: int = 64) -> None:
        if base <= 0 or growth <= 1:
            raise ValueError("need base > 0 and growth > 1")
        self._lock = threading.Lock()
        self.base = base
        self.growth = growth
        self._log_growth = math.log(growth)
        self.counts = [0] * (num_buckets + 1)  # [0] = underflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def _bucket(self, value: float) -> int:
        if value < self.base:
            return 0
        i = int(math.log(value / self.base) / self._log_growth) + 1
        return min(i, len(self.counts) - 1)

    def observe(self, value: float) -> None:
        b = self._bucket(value)
        with self._lock:
            self.counts[b] += 1
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    def merge(self, other: "Histogram") -> "Histogram":
        if (other.base, other.growth, len(other.counts)) != (
                self.base, self.growth, len(self.counts)):
            raise ValueError("histogram bucket layouts differ")
        with other._lock:
            counts = list(other.counts)
            count, total = other._count, other._sum
            lo, hi = other._min, other._max
        with self._lock:
            for i, c in enumerate(counts):
                self.counts[i] += c
            self._count += count
            self._sum += total
            if lo < self._min:
                self._min = lo
            if hi > self._max:
                self._max = hi
        return self

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def to_state(self) -> dict:
        """Plain-dict dump of the histogram (bucket layout + counts).
        Picklable/JSON-safe — the ``threading.Lock`` inside a live
        ``Histogram`` is not — so per-process histograms can cross a
        multiprocessing pipe and be merged in the parent."""
        with self._lock:
            return {
                "base": self.base,
                "growth": self.growth,
                "counts": list(self.counts),
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
            }

    @classmethod
    def from_state(cls, state: dict) -> "Histogram":
        h = cls(base=float(state["base"]), growth=float(state["growth"]),
                num_buckets=len(state["counts"]) - 1)
        h.counts = [int(c) for c in state["counts"]]
        h._count = int(state["count"])
        h._sum = float(state["sum"])
        h._min = float(state["min"])
        h._max = float(state["max"])
        return h

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0..1) by linear interpolation inside
        the bucket containing the target rank.  Exact observed min/max
        clamp the ends so p0/p100 are faithful."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1]")
        with self._lock:
            if self._count == 0:
                return 0.0
            target = q * self._count
            seen = 0.0
            for i, c in enumerate(self.counts):
                if c == 0:
                    continue
                if seen + c >= target:
                    frac = 0.5 if c == 0 else (target - seen) / c
                    if i == 0:
                        lo, hi = 0.0, self.base
                    else:
                        lo = self.base * self.growth ** (i - 1)
                        hi = lo * self.growth
                    est = lo + frac * (hi - lo)
                    return min(max(est, self._min), self._max)
                seen += c
            return self._max

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
            lo, hi = self._min, self._max
        if count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {
            "count": count, "sum": total, "min": lo, "max": hi,
            "mean": total / count,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Named metrics behind one ``snapshot()`` tree.

    Names are dotted paths (``engine.layer.spill_bytes``); the snapshot
    nests on the dots.  ``counter``/``gauge``/``histogram`` are
    get-or-create and type-checked, so independent components can share
    a registry without coordination.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is {type(m).__name__}, "
                    f"not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, Gauge)

    def histogram(self, name: str, base: float = 1e-6, growth: float = 2.0,
                  num_buckets: int = 64) -> Histogram:
        return self._get(
            name, Histogram,
            lambda: Histogram(base=base, growth=growth,
                             num_buckets=num_buckets),
        )

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._metrics.items())
        tree: dict = {}
        for name, metric in sorted(items):
            node = tree
            parts = name.split(".")
            for p in parts[:-1]:
                nxt = node.setdefault(p, {})
                if not isinstance(nxt, dict):
                    # a leaf already holds this prefix; nest it under its
                    # own key so both survive in the tree
                    nxt = node[p] = {"": nxt}
                node = nxt
            node[parts[-1]] = metric.snapshot()
        return tree


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
