"""Span tracer, a copy of ``repro.obs.trace`` (the port imports nothing of
the JAX package): per-request / per-instance timelines on both planes.

The model is deliberately tiny — four primitives, one timebase:

  - ``begin(track, name, t)`` / ``end(track, name, t)`` — an open span,
    keyed by ``(track, name)``; used when the end time is only known
    later (the sim plane's decode steps).
  - ``span(track, name, start, end)`` — a complete span in one call;
    used when both edges are known at record time (adapter loads, the
    cluster plane's round-bounded decode steps).
  - ``instant(track, name, t)`` — a point event (KV page allocation,
    store prefetch kickoff, autoscaler actions).
  - ``counter(track, name, t, value)`` — a sampled time series (queue
    depth per round).

``t`` is ALWAYS the producing plane's virtual time in seconds: the
round clock on the cluster, the event heap's clock on the sim. Wall
clock never enters the timebase — it may ride along as a span argument
(``wall_ms=``). Exporters (``repro_torch.obs.export``) turn the recorded
timeline into Chrome/Perfetto trace JSON or JSONL.

``NULL_TRACER`` is the default everywhere: all methods are no-ops that
allocate nothing, and ``enabled`` is False so hot paths can skip even
building the call arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Span:
    """One recorded interval (or point, when ``end == start``)."""
    track: str
    name: str
    start: float
    end: float
    args: Optional[Dict[str, object]] = None

    @property
    def duration(self) -> float:
        return self.end - self.start


class Tracer:
    """The tracing protocol both planes program against. The base class
    IS the null implementation contract: subclasses that record set
    ``enabled = True``; callers guard expensive argument construction on
    it. All timestamps are the caller's virtual-time seconds."""
    enabled: bool = False

    def begin(self, track: str, name: str, t: float, **args) -> None:
        """Open a span keyed by ``(track, name)``."""

    def end(self, track: str, name: str, t: float, **args) -> None:
        """Close the matching open span (no-op if none is open)."""

    def span(self, track: str, name: str, start: float, end: float,
             **args) -> None:
        """Record a complete span in one call."""

    def instant(self, track: str, name: str, t: float, **args) -> None:
        """Record a point event."""

    def counter(self, track: str, name: str, t: float,
                value: float) -> None:
        """Record one sample of a time series."""

    def finish(self, t: float) -> None:
        """Close any still-open spans at time ``t``."""


class NullTracer(Tracer):
    """Zero-cost tracer: records nothing, allocates nothing. The default
    on every plane (``ServeConfig.trace=False``)."""
    __slots__ = ()


NULL_TRACER = NullTracer()


class TimelineTracer(Tracer):
    """Recording tracer: appends every primitive to in-memory lists that
    the exporters read. Single-threaded by design — both planes drive it
    from their main loop only."""
    enabled = True

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.instants: List[Span] = []
        self.counters: List[Tuple[str, str, float, float]] = []
        self._open: Dict[Tuple[str, str], Tuple[float, Optional[Dict]]] = {}

    def begin(self, track: str, name: str, t: float, **args) -> None:
        self._open[(track, name)] = (float(t), args or None)

    def end(self, track: str, name: str, t: float, **args) -> None:
        opened = self._open.pop((track, name), None)
        if opened is None:
            return                      # unmatched end: drop, don't invent
        start, a = opened
        if args:
            a = {**(a or {}), **args}
        self.spans.append(Span(track, name, start, float(t), a))

    def span(self, track: str, name: str, start: float, end: float,
             **args) -> None:
        self.spans.append(Span(track, name, float(start), float(end),
                               args or None))

    def instant(self, track: str, name: str, t: float, **args) -> None:
        self.instants.append(Span(track, name, float(t), float(t),
                                  args or None))

    def counter(self, track: str, name: str, t: float,
                value: float) -> None:
        self.counters.append((track, name, float(t), float(value)))

    def finish(self, t: float) -> None:
        """Close every open span at ``max(t, start)`` — called once at
        export/drain time so a trace never loses in-flight work."""
        for (track, name), (start, a) in sorted(self._open.items()):
            self.spans.append(Span(track, name, start, max(float(t), start),
                                   a))
        self._open.clear()

    # --------------------------- inspection --------------------------- #
    def tracks(self) -> List[str]:
        """Track names in first-appearance order (stable export layout)."""
        seen: Dict[str, None] = {}
        for s in self.spans:
            seen.setdefault(s.track, None)
        for s in self.instants:
            seen.setdefault(s.track, None)
        for track, _, _, _ in self.counters:
            seen.setdefault(track, None)
        return list(seen)

    def spans_for(self, track: str) -> List[Span]:
        """Spans on one track, sorted by (start, end)."""
        return sorted((s for s in self.spans if s.track == track),
                      key=lambda s: (s.start, s.end))
