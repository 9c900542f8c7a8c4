"""Exporters: Chrome/Perfetto trace-event JSON, Prometheus text, JSONL (a
copy of ``repro.obs.export``).

All three are pure functions of a recorded ``TimelineTracer`` /
``MetricsRegistry`` — no I/O except the explicit ``write_*`` helpers.
The Perfetto output loads directly in https://ui.perfetto.dev or
chrome://tracing (legacy "JSON trace event" format: ``ph="X"`` complete
events with microsecond ``ts``/``dur``, one ``tid`` per track).
"""
from __future__ import annotations

import json
from typing import Dict, List

from repro_torch.obs.registry import Histogram, MetricsRegistry
from repro_torch.obs.trace import TimelineTracer

_US = 1e6   # trace-event timestamps are microseconds


def to_perfetto(tracer: TimelineTracer,
                process_name: str = "repro-serve") -> Dict:
    """The trace as a Chrome/Perfetto trace-event dict. Tracks map to
    threads of one synthetic process, in first-appearance order; span
    args ride through unchanged."""
    tids = {track: i + 1 for i, track in enumerate(tracer.tracks())}
    events: List[Dict] = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
        "args": {"name": process_name},
    }]
    for track, tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid, "args": {"name": track}})
        events.append({"name": "thread_sort_index", "ph": "M", "pid": 1,
                       "tid": tid, "args": {"sort_index": tid}})
    for s in sorted(tracer.spans, key=lambda s: (s.start, s.track, s.name)):
        ev = {"name": s.name, "cat": s.track, "ph": "X",
              "ts": s.start * _US, "dur": s.duration * _US,
              "pid": 1, "tid": tids[s.track]}
        if s.args:
            ev["args"] = dict(s.args)
        events.append(ev)
    for s in sorted(tracer.instants,
                    key=lambda s: (s.start, s.track, s.name)):
        ev = {"name": s.name, "cat": s.track, "ph": "i", "s": "t",
              "ts": s.start * _US, "pid": 1, "tid": tids[s.track]}
        if s.args:
            ev["args"] = dict(s.args)
        events.append(ev)
    for track, name, t, value in tracer.counters:
        events.append({"name": name, "cat": track, "ph": "C",
                       "ts": t * _US, "pid": 1, "tid": tids[track],
                       "args": {name: value}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_perfetto(tracer: TimelineTracer, path: str,
                   process_name: str = "repro-serve") -> None:
    """Serialize ``to_perfetto`` to ``path`` (open in ui.perfetto.dev)."""
    with open(path, "w") as f:
        json.dump(to_perfetto(tracer, process_name), f)


def to_jsonl(tracer: TimelineTracer) -> str:
    """The trace as a JSONL event log: one JSON object per line, in
    record order within each primitive kind — the grep-able flat form."""
    lines: List[str] = []
    for s in tracer.spans:
        lines.append(json.dumps(
            {"type": "span", "track": s.track, "name": s.name,
             "start": s.start, "end": s.end, "args": s.args},
            sort_keys=True))
    for s in tracer.instants:
        lines.append(json.dumps(
            {"type": "instant", "track": s.track, "name": s.name,
             "t": s.start, "args": s.args}, sort_keys=True))
    for track, name, t, value in tracer.counters:
        lines.append(json.dumps(
            {"type": "counter", "track": track, "name": name, "t": t,
             "value": value}, sort_keys=True))
    return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: float) -> str:
    """Prometheus number formatting: integral values print bare."""
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def to_prometheus(registry: MetricsRegistry) -> str:
    """The registry in Prometheus text exposition format (one # HELP /
    # TYPE pair per metric; histograms expand to ``_bucket{le=}``,
    ``_sum`` and ``_count`` series)."""
    out: List[str] = []
    for m in registry:
        out.append(f"# HELP {m.name} {m.help}")
        out.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for ub, c in zip(m.buckets, m.bucket_counts):
                out.append(f'{m.name}_bucket{{le="{_fmt(ub)}"}} {c}')
            out.append(f'{m.name}_bucket{{le="+Inf"}} {m.count}')
            out.append(f"{m.name}_sum {_fmt(m.sum)}")
            out.append(f"{m.name}_count {m.count}")
        else:
            out.append(f"{m.name} {_fmt(m.value)}")
    return "\n".join(out) + ("\n" if out else "")
