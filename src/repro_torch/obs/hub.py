"""ObservabilityHub: lifecycle events -> request-stage spans + metrics (a
copy of ``repro.obs.hub``).

The hub sits at the one point both planes already share — the front
door's event stream (``ServeSystem.step``) — so request-stage
attribution is computed by identical code regardless of plane:

    queued  span: ``queued`` event  -> ``prefill`` event
    prefill span: ``prefill`` event -> first ``token`` event
    decode  span: first ``token``   -> ``finished``/``cancelled``

Together the three cover a request's full TTFT window (queue wait +
staging/prefill) plus its decode tail; child spans (adapter loads, KV
allocation, per-instance decode steps) are recorded deeper in the
stack by the cluster/simulator/cache layers onto the same tracer.

``Observability`` is the user-facing facade returned by
``ServeSystem.observability()``: it bundles the tracer + registry with
the exporters and republishes the existing stat surfaces
(``kv_stats``/``cache_stats``/``transport_stats``/``Summary``) into
the registry so the Prometheus view agrees with the legacy dicts.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

from repro_torch.obs.export import (to_jsonl, to_perfetto, to_prometheus,
                              write_perfetto)
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer


_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _req_track(rid: int) -> str:
    return f"req:{rid}"


class ObservabilityHub:
    """Folds the lifecycle event stream into request spans and typed
    metrics. Driven only when tracing is on — with ``NULL_TRACER`` the
    front door never calls it, so the off path stays zero-cost."""

    def __init__(self, tracer: Optional[Tracer] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        # rid -> (current stage name, stage start time)
        self._stage: Dict[int, Tuple[str, float]] = {}
        self._queued_at: Dict[int, float] = {}
        self._first_token: Dict[int, float] = {}
        self._tokens: Dict[int, int] = {}
        r = self.registry
        self._c_queued = r.counter(
            "requests_queued_total", "requests that entered the queue")
        self._c_finished = r.counter(
            "requests_finished_total", "requests that finished decoding")
        self._c_cancelled = r.counter(
            "requests_cancelled_total", "requests cancelled mid-flight")
        self._c_tokens = r.counter(
            "tokens_decoded_total", "decode tokens emitted")
        self._c_scale = r.counter(
            "scale_actions_total", "autoscaler actions applied")
        self._h_queue = r.histogram(
            "queue_wait_seconds", "queued -> prefill admission wait")
        self._h_ttft = r.histogram(
            "ttft_seconds", "queued -> first token")
        self._h_tpot = r.histogram(
            "tpot_seconds", "mean inter-token time per finished request")

    def on_event(self, ev) -> None:
        """Consume one front-door ``Event`` (any plane)."""
        tr, t, rid, kind = self.tracer, ev.time, ev.rid, ev.kind
        if kind.startswith("scale"):
            if ev.detail is not None:
                tr.instant("control", kind, t, reason=ev.detail)
            else:
                tr.instant("control", kind, t)
            self._c_scale.inc()
            return
        track = _req_track(rid)
        if kind == "queued":
            tr.begin(track, "queued", t)
            self._stage[rid] = ("queued", t)
            self._queued_at[rid] = t
            self._c_queued.inc()
        elif kind == "prefill":
            tr.end(track, "queued", t)
            tr.begin(track, "prefill", t)
            self._h_queue.observe(t - self._queued_at.get(rid, t))
            self._stage[rid] = ("prefill", t)
        elif kind == "token":
            self._c_tokens.inc()
            n = self._tokens.get(rid, 0) + 1
            self._tokens[rid] = n
            if n == 1:
                tr.end(track, "prefill", t)
                tr.begin(track, "decode", t)
                self._first_token[rid] = t
                self._h_ttft.observe(t - self._queued_at.get(rid, t))
                self._stage[rid] = ("decode", t)
        elif kind in ("finished", "cancelled"):
            stage = self._stage.pop(rid, None)
            if stage is not None:
                tr.end(track, stage[0], t)
            if kind == "finished":
                self._c_finished.inc()
                n = self._tokens.get(rid, 0)
                first = self._first_token.get(rid)
                if first is not None and n > 1:
                    self._h_tpot.observe((t - first) / (n - 1))
            else:
                self._c_cancelled.inc()
            self._queued_at.pop(rid, None)
            self._first_token.pop(rid, None)
            self._tokens.pop(rid, None)

    def publish_summary(self, summary) -> None:
        """Mirror every numeric ``Summary`` field into ``summary_<field>``
        gauges — the existing dataclass stays the source of truth; the
        registry is the exportable view of it."""
        for f in dataclasses.fields(summary):
            v = getattr(summary, f.name)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            self.registry.gauge(f"summary_{f.name}",
                                f"metrics.Summary.{f.name}").set(v)

    def publish_stats(self, prefix: str, stats: Dict) -> None:
        """Flatten one of the legacy stat dicts (numeric leaves only)
        into ``<prefix>_<key>`` gauges. Keys are sanitized to the
        Prometheus name alphabet (the shared-cache dict is keyed -1)."""
        for k, v in stats.items():
            if isinstance(v, bool):
                continue
            name = _NAME_RE.sub("_", f"{prefix}_{k}")
            if isinstance(v, (int, float)):
                self.registry.gauge(name).set(v)
            elif isinstance(v, dict):
                self.publish_stats(name, v)


class Observability:
    """Facade over a serving system's tracer + registry + exporters
    (returned by ``ServeSystem.observability()``)."""

    def __init__(self, hub: ObservabilityHub, backend):
        self._hub = hub
        self._backend = backend

    @property
    def tracer(self) -> Tracer:
        """The system's tracer (``NULL_TRACER`` unless ``trace=True``)."""
        return self._hub.tracer

    @property
    def registry(self) -> MetricsRegistry:
        """The system's metrics registry."""
        return self._hub.registry

    def refresh(self) -> None:
        """Republish the backend's pull-style stat surfaces (KV
        occupancy, cache tiers, transport dispatch/rank telemetry, queue
        depth) into the registry as gauges."""
        b = self._hub.publish_stats
        kv = self._backend.kv_stats()
        if kv:
            agg: Dict[str, float] = {}
            for st in kv.values():
                for k, v in st.items():
                    if isinstance(v, (int, float)) and \
                            not isinstance(v, bool):
                        agg[k] = agg.get(k, 0.0) + v
            b("kv", agg)
        b("cache", self._backend.cache_stats())
        b("transport", self._backend.transport_stats())
        inner = getattr(self._backend, "cluster", None) or \
            getattr(self._backend, "sim", None)
        sched = getattr(inner, "sched", None)
        if sched is not None:
            self._hub.registry.gauge(
                "queue_depth", "requests waiting for admission").set(
                    sched.queue_len())

    def _finalize(self) -> None:
        if self._hub.tracer.enabled:
            self._hub.tracer.finish(self._backend.now)

    def perfetto(self) -> Dict:
        """The trace as a Chrome/Perfetto trace-event dict (in-flight
        spans are closed at the backend's current time)."""
        self._finalize()
        return to_perfetto(self._hub.tracer)

    def write_trace(self, path: str) -> None:
        """Write the Perfetto trace JSON to ``path``."""
        self._finalize()
        write_perfetto(self._hub.tracer, path)

    def jsonl(self) -> str:
        """The trace as a JSONL event log."""
        self._finalize()
        return to_jsonl(self._hub.tracer)

    def prometheus(self) -> str:
        """The registry in Prometheus text format (refreshed first)."""
        self.refresh()
        return to_prometheus(self._hub.registry)
