"""Observability plane of the port (a copy of ``repro.obs``): span
tracing, a typed metrics registry, and exporters (Chrome/Perfetto trace
JSON, Prometheus text, JSONL). It imports nothing of ``repro_torch.serving``:
the serving layers depend on it, never the reverse."""
from repro_torch.obs.clock import wall_time
from repro_torch.obs.export import (to_jsonl, to_perfetto, to_prometheus,
                                    write_perfetto)
from repro_torch.obs.hub import Observability, ObservabilityHub
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Span,
                                   TimelineTracer, Tracer)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "TimelineTracer", "Span",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "ObservabilityHub", "Observability",
    "to_perfetto", "to_prometheus", "to_jsonl", "write_perfetto",
    "wall_time",
]
