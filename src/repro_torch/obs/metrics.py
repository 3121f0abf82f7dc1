"""Metrics registry: counters, gauges, histograms with labels (the port of
``repro.obs.metrics``, the same snapshots for the same observations).

The registry replaces the scattered ad-hoc floats (aux dicts, engine
attributes, print lines) with one named, labelled, snapshot-able store that
``sim/engine.py``, ``comm/accounting.PayloadLedger``, ``wireless/latency``
and ``core/hfl`` all emit into.

Design constraints, in order:

  * **lock-free append** — updates are single dict/float ops under the
    GIL; no locks on the hot path. The engine is single-threaded; the
    registry merely must not *add* synchronization.
  * **zero overhead when disabled** — ``NULL_REGISTRY`` hands out one
    shared no-op metric object; ``counter(...)``/``inc(...)`` on it
    allocate nothing. Emit sites guard with ``reg.enabled`` where even
    the no-op call would be too much (per-event loops).
  * **snapshot-to-dict determinism** — ``snapshot()`` sorts metric and
    series keys, so two registries fed the same observations (in any
    label order) snapshot identically; the result is plain-JSON.

Label series are keyed by the sorted ``(key, value)`` tuple of the labels,
rendered ``"k=v,k2=v2"`` in snapshots (empty string for the bare series).

Modules that cannot thread a registry handle (the pricing functions, the
sync-step builders) emit into the *ambient* registry:
``current_registry()`` returns the installed one (``set_registry`` /
``use_registry``), defaulting to ``NULL_REGISTRY``.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np

# histogram bucket upper bounds (log-spaced, generous range: seconds, bits
# and rates all land somewhere sane); the overflow bucket is implicit
DEFAULT_BUCKETS = tuple(10.0 ** e for e in range(-6, 13))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_str(key: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


class Counter:
    """Monotone accumulator; ``inc(value, **labels)``."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.series: dict = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        k = _label_key(labels)
        self.series[k] = self.series.get(k, 0.0) + value

    def value(self, **labels) -> float:
        return self.series.get(_label_key(labels), 0.0)

    def _snap(self):
        return {_label_str(k): v for k, v in sorted(self.series.items())}


class Gauge:
    """Last-write-wins value; ``set(value, **labels)``."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.series: dict = {}

    def set(self, value: float, **labels) -> None:
        self.series[_label_key(labels)] = float(value)

    def value(self, **labels) -> Optional[float]:
        return self.series.get(_label_key(labels))

    def _snap(self):
        return {_label_str(k): v for k, v in sorted(self.series.items())}


class Histogram:
    """Aggregated observations: count/sum/min/max + bucket counts.

    Stores aggregates, not raw samples, so a million-event run costs O(1)
    memory per series. ``observe`` accepts a scalar or an array (the
    per-cluster pricing vectors land in one call).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS):
        self.name, self.help = name, help
        self.buckets = tuple(float(b) for b in buckets)
        self.series: dict = {}  # key -> [count, sum, min, max, bucket_counts]

    def observe(self, value, **labels) -> None:
        v = np.atleast_1d(np.asarray(value, np.float64))
        v = v[np.isfinite(v)]
        if v.size == 0:
            return
        k = _label_key(labels)
        s = self.series.get(k)
        if s is None:
            s = [0, 0.0, np.inf, -np.inf,
                 np.zeros(len(self.buckets) + 1, np.int64)]
            self.series[k] = s
        s[0] += int(v.size)
        s[1] += float(v.sum())
        s[2] = min(s[2], float(v.min()))
        s[3] = max(s[3], float(v.max()))
        s[4] += np.bincount(np.searchsorted(self.buckets, v),
                            minlength=len(self.buckets) + 1)

    def _quantile(self, bc, q: float, count: int, mn: float, mx: float):
        """Deterministic quantile estimate from the bucket counts: walk
        the sorted bucket bounds until the cumulative count reaches the
        rank, report that bucket's upper bound clamped to the observed
        [min, max]. Exact when a bucket holds one distinct value; within
        one log-decade otherwise — stable across hosts either way."""
        rank = q * count
        cum = 0
        for i, c in enumerate(bc):
            cum += int(c)
            if cum >= rank:
                hi = self.buckets[i] if i < len(self.buckets) else mx
                return float(min(max(hi, mn), mx))
        return float(mx)

    def _snap(self):
        out = {}
        for k, (count, total, mn, mx, bc) in sorted(self.series.items()):
            out[_label_str(k)] = {
                "count": count, "sum": total, "min": mn, "max": mx,
                "mean": total / count,
                "p50": self._quantile(bc, 0.50, count, mn, mx),
                "p95": self._quantile(bc, 0.95, count, mn, mx),
                "p99": self._quantile(bc, 0.99, count, mn, mx),
                "buckets": [int(c) for c in bc],
            }
        return out


class MetricsRegistry:
    """Named metric store; metric objects are cached by name."""

    enabled = True

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {m.kind}, not "
                            f"a {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def snapshot(self) -> dict:
        """Deterministic plain-JSON dict of every metric's series."""
        return {
            name: {"kind": m.kind, "help": m.help, "series": m._snap()}
            for name, m in sorted(self._metrics.items())
        }


class _NullMetric:
    """Shared no-op metric: every method discards its arguments."""

    kind = "null"
    name = help = ""

    def inc(self, value: float = 1.0, **labels) -> None:
        pass

    def set(self, value: float, **labels) -> None:
        pass

    def observe(self, value, **labels) -> None:
        pass

    def value(self, **labels):
        return None


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """Disabled registry: hands out the shared no-op metric, snapshots
    empty. One instance (``NULL_REGISTRY``) serves every disabled run —
    requesting a metric or emitting into it allocates nothing."""

    enabled = False

    def counter(self, name: str, help: str = "") -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str, help: str = "") -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> _NullMetric:
        return _NULL_METRIC

    def snapshot(self) -> dict:
        return {}


NULL_REGISTRY = NullRegistry()

# ambient registry for modules that cannot thread a handle (wireless
# pricing, sync-step builders). Installed by Telemetry / launch/train.py.
_current = NULL_REGISTRY


def current_registry():
    return _current


def set_registry(reg) -> None:
    global _current
    _current = reg if reg is not None else NULL_REGISTRY


@contextlib.contextmanager
def use_registry(reg):
    """Scoped ``set_registry`` (tests; nested runs)."""
    global _current
    prev, _current = _current, (reg if reg is not None else NULL_REGISTRY)
    try:
        yield reg
    finally:
        _current = prev
