"""Thread-safe metrics primitives: Counter, Gauge, Histogram + registry.

A copy of the JAX package's registry (`incubator_mxnet_tpu/telemetry/
metrics.py`), its locks named for the lock sanitizer (`san_lock`) as
there. Label resolution caches the child series in a dict, so the hot
path is a dict hit plus a tiny per-child critical section.
"""
from __future__ import annotations

import bisect

from ..analysis.sanitizers import san_lock

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DEFAULT_BUCKETS", "BYTES_BUCKETS",
]

# latency-oriented buckets in seconds (Prometheus client defaults, extended
# half a decade down)
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
# payload-size buckets, 4 KiB to 1 GiB by powers of 4
BYTES_BUCKETS = tuple(float(4 * 1024 * 4 ** i) for i in range(10))


def _label_key(labels):
    return tuple(sorted(labels.items()))


class _Metric:
    """Base: a named family of label-keyed series."""

    kind = "untyped"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = san_lock("telemetry.metric")
        self._children = {}

    def labels(self, **labels):
        """Get-or-create the child series for this label set (cached)."""
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child()
                    self._children[key] = child
        return child

    def series(self):
        """Snapshot: [(labels_dict, child), ...] in stable label order."""
        with self._lock:
            items = sorted(self._children.items())
        return [(dict(key), child) for key, child in items]


class _CounterChild:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = san_lock("telemetry.counter_child")
        self.value = 0.0

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self.value += amount


class Counter(_Metric):
    """Monotonically increasing value."""

    kind = "counter"
    _make_child = staticmethod(_CounterChild)

    def inc(self, amount=1.0, **labels):
        self.labels(**labels).inc(amount)

    def value(self, **labels):
        return self.labels(**labels).value


class _GaugeChild:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = san_lock("telemetry.gauge_child")
        self.value = 0.0

    def set(self, value):
        with self._lock:
            self.value = float(value)

    def set_max(self, value):
        """Watermark update: keep the max ever seen."""
        value = float(value)
        with self._lock:
            if value > self.value:
                self.value = value

    def inc(self, amount=1.0):
        with self._lock:
            self.value += amount

    def dec(self, amount=1.0):
        self.inc(-amount)


class Gauge(_Metric):
    """Point-in-time value that can go both ways (queue depths, pages in
    use); `set_max` gives watermark semantics."""

    kind = "gauge"
    _make_child = staticmethod(_GaugeChild)

    def set(self, value, **labels):
        self.labels(**labels).set(value)

    def set_max(self, value, **labels):
        self.labels(**labels).set_max(value)

    def inc(self, amount=1.0, **labels):
        self.labels(**labels).inc(amount)

    def dec(self, amount=1.0, **labels):
        self.labels(**labels).dec(amount)

    def value(self, **labels):
        return self.labels(**labels).value


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "buckets", "count", "sum", "min", "max")

    def __init__(self, bounds):
        self._lock = san_lock("telemetry.hist_child")
        self._bounds = bounds
        self.buckets = [0] * (len(bounds) + 1)  # last slot: +Inf
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, value):
        value = float(value)
        idx = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self.buckets[idx] += 1
            self.count += 1
            self.sum += value
            if self.min is None or value < self.min:
                self.min = value
            if self.max is None or value > self.max:
                self.max = value

    def snapshot(self):
        """Consistent copy: (bounds, bucket counts, count, sum, min, max)."""
        with self._lock:
            return (self._bounds, list(self.buckets), self.count, self.sum,
                    self.min, self.max)


class Histogram(_Metric):
    """Distribution with fixed upper-bound buckets."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value, **labels):
        self.labels(**labels).observe(value)


class MetricsRegistry:
    """Name -> metric family. One process-wide default (`REGISTRY`);
    tests may instantiate their own."""

    def __init__(self):
        self._lock = san_lock("telemetry.registry")
        self._metrics = {}

    def _get_or_create(self, name, kind, factory):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = factory()
                    self._metrics[name] = m
        if m.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {kind}")
        return m

    def counter(self, name, help=""):
        return self._get_or_create(name, "counter",
                                   lambda: Counter(name, help))

    def gauge(self, name, help=""):
        return self._get_or_create(name, "gauge", lambda: Gauge(name, help))

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS):
        return self._get_or_create(
            name, "histogram", lambda: Histogram(name, help, buckets))

    def get(self, name):
        return self._metrics.get(name)

    def collect(self):
        """Snapshot of all families, name-sorted (stable export order)."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self):
        with self._lock:
            self._metrics.clear()


REGISTRY = MetricsRegistry()
