"""Serving metrics (paper §6.1): P95 TTFT, mean TPOT, throughput, and the
adapter-level SLO Attainment Rate (fraction of adapters whose requests meet
both SLOs in >90% of cases); a copy of ``repro.serving.metrics``."""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Sequence

import numpy as np

from repro_torch.serving.workload import Request

TTFT_SLO = 0.25   # s, P95 (paper)
TPOT_SLO = 0.10   # s, average (paper)
ATTAIN_THRESHOLD = 0.90


@dataclasses.dataclass
class Summary:
    n_requests: int
    n_finished: int
    p95_ttft: float
    mean_ttft: float
    mean_tpot: float
    throughput_rps: float
    slo_attainment: float       # fraction of adapters >90% compliant
    goodput_rps: float          # finished requests meeting both SLOs / s
    per_adapter_ok: Dict[int, float] = dataclasses.field(default_factory=dict)
    n_censored: int = 0         # in-window, never finished (incl. no first
    #                             token): SLO violations of unbounded TTFT
    n_cancelled: int = 0        # client-cancelled: excluded from throughput,
    #                             goodput, and attainment (not a violation)
    # adapter-plane telemetry (from Backend.cache_stats; nan = not supplied)
    cache_hit_rate: float = float("nan")      # device-tier hits/(hits+miss)
    prefetch_hit_rate: float = float("nan")   # hint-admitted hits/(hits+miss)
    host_hit_rate: float = float("nan")       # host-RAM share of tier misses
    miss_penalty_s: float = float("nan")      # mean full-load s per miss
    # effective-rank telemetry (from Backend.transport_stats; nan = not
    # supplied — coupled mode or a plane with no rank observations)
    mean_active_rank: float = float("nan")    # mean paid rank per active row
    rank_flop_savings: float = float("nan")   # 1 - mean/pool (padded = 0)

    def meets_slos(self, ttft_slo=TTFT_SLO, tpot_slo=TPOT_SLO) -> bool:
        return self.p95_ttft <= ttft_slo and self.mean_tpot <= tpot_slo


def _cache_telemetry(cache_stats: Dict) -> Dict[str, float]:
    """Fold Backend.cache_stats ({"caches": {cid: counters}, "store":
    tier counters}) into the four Summary telemetry rates."""
    out = {}
    caches = (cache_stats or {}).get("caches", {})
    hits = sum(c.get("hits", 0) for c in caches.values())
    misses = sum(c.get("misses", 0) for c in caches.values())
    pre = sum(c.get("prefetch_hits", 0) for c in caches.values())
    load_s = sum(c.get("miss_load_seconds", 0.0) for c in caches.values())
    if hits + misses > 0:
        out["cache_hit_rate"] = hits / (hits + misses)
        out["prefetch_hit_rate"] = pre / (hits + misses)
    if misses > 0:
        out["miss_penalty_s"] = load_s / misses
    store = (cache_stats or {}).get("store", {})
    tier = store.get("host_hits", 0) + store.get("disk_hits", 0)
    if tier > 0:
        out["host_hit_rate"] = store["host_hits"] / tier
    return out


def _rank_telemetry(transport_stats: Dict) -> Dict[str, float]:
    """Fold Backend.transport_stats' effective-rank keys into Summary
    (nan when the plane never observed an active row)."""
    out = {}
    ts = transport_stats or {}
    if ts.get("mean_active_rank", 0):
        out["mean_active_rank"] = float(ts["mean_active_rank"])
        out["rank_flop_savings"] = float(ts.get("rank_flop_savings", 0.0))
    return out


def summarize(requests: Sequence[Request], duration: float,
              ttft_slo: float = TTFT_SLO, tpot_slo: float = TPOT_SLO,
              warmup: float = 0.1, cache_stats: Dict = None,
              transport_stats: Dict = None) -> Summary:
    """Steady-state stats (drop the first ``warmup`` fraction, paper Fig. 6
    measures 30-270 s of a 300 s run)."""
    t0 = duration * warmup
    t1 = duration * 0.9
    window = [r for r in requests if t0 <= r.arrival <= t1]
    # client cancellations are neither completions nor SLO violations — the
    # request left the system on purpose; drop them from every rate/SLO stat
    # but report the count
    cancelled = [r for r in window if r.cancelled]
    window = [r for r in window if not r.cancelled]
    # a finish stamp without a first-token stamp is corrupt bookkeeping (e.g.
    # a requeued request force-finished) — censor it rather than let an inf
    # ttft/tpot poison the means
    done = [r for r in window if r.finish >= 0 and r.first_token >= 0]
    # censoring: requests that never finished are SLO violations with
    # unbounded TTFT (counting only survivors would hide queue collapse)
    censored = [r for r in window if r.finish < 0 or r.first_token < 0]
    telemetry = _cache_telemetry(cache_stats)
    telemetry.update(_rank_telemetry(transport_stats))
    if not done:
        return Summary(len(requests), 0, float("inf"), float("inf"),
                       float("inf"), 0.0, 0.0, 0.0,
                       n_censored=len(censored), n_cancelled=len(cancelled),
                       **telemetry)
    ttfts = np.array([r.ttft for r in done] +
                     [np.inf] * len(censored))
    tpots = np.array([r.tpot for r in done])
    # rates divide by the ADMISSION window the numerator was filtered to,
    # [t0, t1] — dividing by duration - t0 (the old span) understated
    # throughput/goodput by warmup/(1-warmup) (~11% at the default 0.1)
    span = t1 - t0
    per_adapter = defaultdict(list)
    for r in done:
        ok = (r.ttft <= ttft_slo) and (r.tpot <= tpot_slo)
        per_adapter[r.adapter_id].append(ok)
    for r in censored:
        per_adapter[r.adapter_id].append(False)
    attain = {a: float(np.mean(v)) for a, v in per_adapter.items()}
    n_good = sum(1 for a, v in attain.items() if v > ATTAIN_THRESHOLD)
    good_reqs = sum(1 for r in done
                    if r.ttft <= ttft_slo and r.tpot <= tpot_slo)
    # percentile interpolates linearly; between two censored (inf) samples
    # that is inf - inf = nan, which can only mean the percentile itself is
    # censored — report inf, not nan
    with np.errstate(invalid="ignore"):
        p95 = float(np.percentile(ttfts, 95))
    return Summary(
        n_requests=len(requests), n_finished=len(done),
        p95_ttft=float("inf") if np.isnan(p95) else p95,
        mean_ttft=float(np.mean([r.ttft for r in done])),
        mean_tpot=float(tpots.mean()),
        throughput_rps=len(done) / span,
        slo_attainment=n_good / max(len(attain), 1),
        goodput_rps=good_reqs / span,
        per_adapter_ok=attain,
        n_censored=len(censored),
        n_cancelled=len(cancelled),
        **telemetry,
    )


def max_serviceable_rate(run_fn, rates: Sequence[float],
                         ttft_slo: float = TTFT_SLO,
                         tpot_slo: float = TPOT_SLO) -> float:
    """Largest rate whose Summary meets both SLOs (paper's 'serviceable
    request rate'). run_fn(rate) -> Summary."""
    best = 0.0
    for rate in rates:
        s = run_fn(rate)
        if s.meets_slos(ttft_slo, tpot_slo):
            best = rate
        else:
            break
    return best
