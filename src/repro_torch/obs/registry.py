"""Typed metrics registry: counters, gauges, histograms (a copy of
``repro.obs.registry``; the port imports nothing of the JAX package).

Replaces hand-rolled dict telemetry with three explicit types that the
Prometheus exporter can render without guessing semantics:

  - ``Counter`` — monotonically increasing total (requests, tokens,
    scale actions, cache hits).
  - ``Gauge`` — last-write-wins level (queue depth, slots/pages in use,
    mean effective rank).
  - ``Histogram`` — cumulative-bucket distribution (per-stage latency:
    queue wait, TTFT, TPOT), Prometheus ``le`` convention.

``MetricsRegistry`` is get-or-create by name: asking twice returns the
same instrument, asking for the same name with a different type raises.
Existing surfaces (``metrics.Summary``, ``cache_stats``,
``transport_stats``) are unchanged — ``Observability`` republishes them
into the registry so both views agree (see ``repro_torch.obs.hub``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple, Union

# Latency-oriented default buckets (seconds): sub-ms to minutes, the
# span both planes' virtual clocks actually produce.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                   1.0, 5.0, 10.0, 60.0)


class Counter:
    """Monotonic total. ``inc()`` with a negative amount raises."""
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount


class Gauge:
    """Last-write-wins level."""
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Histogram:
    """Cumulative-bucket histogram (Prometheus ``le`` semantics): each
    observation lands in every bucket whose upper bound is >= it, plus
    the implicit ``+Inf`` bucket, ``sum`` and ``count``."""
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        if list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must ascend")
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        self.bucket_counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.bucket_counts[i] += 1

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper bound of the first
        bucket holding the q-th observation; +inf past the last bound)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return 0.0
        target = q * self.count
        running = 0
        for ub, n in zip(self.buckets,
                         _to_incremental(self.bucket_counts)):
            running += n
            if running >= target:
                return ub
        return math.inf


def _to_incremental(cumulative: List[int]) -> List[int]:
    out, prev = [], 0
    for c in cumulative:
        out.append(c - prev)
        prev = c
    return out


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Get-or-create registry keyed by metric name. Iteration yields
    instruments in registration order (stable export layout)."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}

    def _get(self, cls, name: str, help: str, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def __iter__(self):
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    def get(self, name: str):
        """The instrument registered under ``name``, or None."""
        return self._metrics.get(name)

    def snapshot(self) -> Dict[str, float]:
        """Flat name -> value view (histograms contribute ``_count`` and
        ``_sum``) — the cheap programmatic read used by tests/benches."""
        out: Dict[str, float] = {}
        for m in self:
            if isinstance(m, Histogram):
                out[m.name + "_count"] = float(m.count)
                out[m.name + "_sum"] = m.sum
            else:
                out[m.name] = m.value
        return out
