"""The device trace of a traced run: ``torch.profiler`` over a steady
stretch of the window, reduced to what the per-layer metrics read.

  busy_us     the union of the intervals in which any operation (kernel,
              copy, memset) ran on the card
  window_us   the stretch's length: from the first harness span or device
              operation to the last, on the profiler's clock
  by_name     device microseconds and counts by operation name
  gaps        idle intervals of the card, each labelled by the harness
              span the host was in at its midpoint: "submit", "step" (the
              program's ``step()`` outside its decode step), "decode" (the
              decode step: the last ``decode_ms`` of a ``step()``, which
              the program's own span times), "sleep" (waiting for the
              next arrival) or "harness" (the harness's own bookkeeping)

The harness marks its spans with ``record_function("bench.<what>")``, so
host spans and device intervals share the profiler's clock.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

SPAN_PREFIX = "bench."


def _intervals(prof) -> Tuple[List[Tuple[float, float, str]],
                              List[Tuple[float, float, str]]]:
    """(device intervals, harness host spans), each (start_us, end_us,
    name), from the profiler's events."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith(SPAN_PREFIX):
            # a harness span; the profiler also draws it on the card's
            # timeline, where it is no operation
            if e.device_type != DeviceType.CUDA:
                host.append((float(tr.start), float(tr.end),
                             e.name[len(SPAN_PREFIX):]))
        elif e.device_type == DeviceType.CUDA:
            dev.append((float(tr.start), float(tr.end), e.name))
    dev.sort()
    host.sort()
    return dev, host


def _union(dev) -> Tuple[float, List[Tuple[float, float]]]:
    """(busy us, idle gaps between the first and last operation)."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, _ in dev:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def _label(mid: float, host, step_no: Sequence[int],
           decode_ms: Sequence[Optional[float]]) -> str:
    i = bisect.bisect_right(host, (mid, float("inf"), "")) - 1
    if i < 0 or host[i][1] < mid:
        return "harness"
    s, e, name = host[i]
    if name == "step":
        # the round's decode step ends its step(); its length is the
        # program's own decode.step wall time
        k = step_no[i]
        ms = decode_ms[k] if k < len(decode_ms) else None
        if ms is not None and mid >= e - 1e3 * ms:
            return "decode"
    return name


def reduce(prof, decode_ms: Sequence[Optional[float]], top: int = 10
           ) -> Dict:
    """The stretch's busy time, operation time by name and its ``top``
    longest idle gaps.
    ``decode_ms``: the decode step's wall ms of each ``step()`` the
    stretch holds, in order (None where a round decoded nothing)."""
    dev, host = _intervals(prof)
    busy, gaps = _union(dev)
    window_us = 0.0
    if dev:
        first, last = dev[0][0], max(e for _, e, _ in dev)
        lo = min([s for s, _, _ in host] + [first])
        hi = max([e for _, e, _ in host] + [last])
        window_us = hi - lo
        # the card idles before its first and after its last operation too
        gaps = [(lo, first)] + gaps + [(last, hi)]
    by_name: Dict[str, List[float]] = {}
    for s, e, name in dev:
        v = by_name.setdefault(name, [0.0, 0])
        v[0] += e - s
        v[1] += 1
    # each host span's index among the step() spans
    step_no, k = [], 0
    for _, _, name in host:
        step_no.append(k)
        k += name == "step"
    longest = sorted(((e - s, s, e) for s, e in gaps if e > s),
                     reverse=True)[:top]
    labelled = [(length, _label((s + e) / 2, host, step_no, decode_ms))
                for length, s, e in longest]
    return {"busy_us": busy, "window_us": window_us,
            "by_name": by_name, "gaps": labelled, "n_steps": k,
            "n_device_events": len(dev), "n_host_spans": len(host)}


def kernel_us(trace: Dict, needles: Sequence[str]) -> float:
    """Device microseconds of the operations whose name holds any of
    ``needles``."""
    return sum(t for name, (t, _) in trace["by_name"].items()
               if any(n in name for n in needles))
