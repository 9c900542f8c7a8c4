"""Online SLO-driven provisioning: paper §4.2 / Algorithm 1 as a runtime
control loop, a copy of ``repro.serving.autoscaler`` over the port's
float64 provisioning and its cost model (nominal ``H100`` by default).

``core/provisioning.py`` solves the provisioning problem OFFLINE: given an
adapter popularity vector and a lookback batch LB, find the minimum cache
size M* with IAR(M*) >= alpha (Eqs. 1-4) and the minimum server GPU count
meeting the TPOT SLO (Eqs. 5-6). The ``Autoscaler`` feeds those same
functions ONLINE estimates each control interval:

  arrival window  ->  empirical popularity p_i + arrival rate
  Little's law    ->  lookback batch LB = max(in-flight + queued,
                      rate x mean residence of recent finishers)
  min_cache_size  ->  resize_cache      (adapter-cache slot target)
  min_gpus_for_tpot -> add/remove_replica (LoRA-Server replica target)
  LB / max_batch  ->  add/drain_instance (LLM instance target)

and emits typed ``ScaleAction``s that the execution planes apply at round
(cluster) or event (simulator) boundaries; on the cluster plane a control
interval and the window count virtual seconds of ``step_time`` a round.
Scale-up is immediate; scale-down waits ``scale_down_patience``
consecutive low readings so a one-interval lull cannot thrash capacity.

The safety invariant, enforced by test: no action may change any request's
token stream — scaling moves WHERE and WHEN a request decodes, never WHAT
it decodes (greedy decoding depends only on the request's own prompt).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cost_model
from repro_torch.core.cost_model import H100, Hardware
from repro_torch.core.provisioning import iar, min_cache_size, \
    min_gpus_for_tpot

ACTION_KINDS = ("resize_cache", "add_instance", "drain_instance",
                "add_replica", "remove_replica")


@dataclasses.dataclass(frozen=True)
class ScaleAction:
    """One typed provisioning decision. ``target`` is the desired TOTAL
    (cache slots / instance count / replica count) — executors converge to
    it, they do not blindly increment."""
    kind: str
    target: int
    reason: str = ""

    def __post_init__(self):
        if self.kind not in ACTION_KINDS:
            raise ValueError(f"unknown scale action {self.kind!r}")


@dataclasses.dataclass
class AutoscalePolicy:
    """The ``autoscale=`` block of ``ServeConfig``: bounds and cadence for
    the online control loop. All times are virtual seconds (the
    simulator's event clock, the cluster's ``step_time`` a round)."""
    control_interval: float = 5.0   # seconds between control decisions
    window: float = 30.0            # sliding arrival-rate window
    alpha: float = 0.95             # IAR target (Eq. 1)
    slo_tpot: float = 0.1           # feeds min_gpus_for_tpot (Eqs. 5-6)
    min_cache_slots: int = 2
    max_cache_slots: int = 512
    min_instances: int = 1
    max_instances: int = 8
    min_replicas: int = 1
    max_replicas: int = 4
    gpus_per_replica: int = 8       # chips per LoRA-Server replica
    scale_down_patience: int = 2    # consecutive low controls before shrink
    # instance sizing targets this fraction of the fleet's decode slots
    # occupied: provisioning to 1.0 parks the system at saturation, where
    # any arrival burst turns straight into queueing delay (TTFT)
    target_utilization: float = 0.7
    # ignore cache-size targets within this relative band of the current
    # size: every shrink evicts (and later reloads) adapters, so chasing
    # estimator noise tick-by-tick turns into TTFT tail churn
    resize_deadband: float = 0.2


def converge_replicas(pool, target: int) -> bool:
    """Shared by both planes' action executors: grow/shrink ``pool`` to
    ``target`` replicas (never below one). Returns True if the replica set
    changed — the caller must then force a residency re-home sync before
    the next decode step (and, for a slot-PARTITIONED pool, first
    ``LoRACache.repartition`` so no home exceeds its replica's share —
    see ``Cluster._apply_action``)."""
    changed = False
    while pool.n_replicas < target:
        pool.add_replica()
        changed = True
    while pool.n_replicas > max(target, 1):
        pool.remove_replica()
        changed = True
    return changed


def pick_drain_candidate(instances, queues):
    """Shared scale-in victim policy of both planes: the least-loaded
    admitting instance (running + queued work; newest iid on ties, so
    long-lived instances with warm caches survive)."""
    return min((i for i in instances if i.alive and not i.draining),
               key=lambda i: (i.batch + len(queues.get(i.iid, [])),
                              -i.iid))


class Autoscaler:
    """Sliding-window estimator + Algorithm-1 control loop.

    The planes feed it observations (``observe_arrival`` /
    ``observe_finish``) as virtual time advances and call ``control`` at
    boundaries; it rate-limits itself to ``policy.control_interval``."""

    def __init__(self, policy: AutoscalePolicy, model_cfg: ModelConfig, *,
                 max_batch: int, gpus_per_instance: int = 8,
                 hw: Hardware = H100, has_server: bool = True,
                 transport: str = "host", hook_launch_us: float = 0.0):
        self.policy = policy
        self.cfg = model_cfg
        self.max_batch = max(int(max_batch), 1)
        self.gpus_per_instance = gpus_per_instance
        self.hw = hw
        # hook transport plane: the host-mediated launch tail eats into the
        # per-token budget available for server round trips, so the Eqs. 5-6
        # capacity search runs against the derated SLO (see
        # cost_model.transport_dispatch_seconds; 0 us = legacy behavior)
        self.transport = transport
        self.hook_launch_us = float(hook_launch_us)
        # coupled planes have no LoRA-Server: skip the Eqs. 5-6 placement
        # search and never emit replica actions (an executor would only
        # drop them, leaving the control loop chasing an unreachable
        # target every tick)
        self.has_server = has_server
        self._arrivals: Deque[Tuple[float, int]] = deque()
        self._residences: Deque[Tuple[float, float]] = deque()
        self._t0: Optional[float] = None
        self._next_control = 0.0
        self._low_streak = {"cache": 0, "instances": 0, "replicas": 0}
        # every control tick: dict(now, rate, lb, targets, actions)
        self.history: List[Dict] = []

    # ------------------------------- inputs --------------------------- #
    def observe_arrival(self, now: float, adapter_id: int) -> None:
        if self._t0 is None:
            self._t0 = now
        self._arrivals.append((now, int(adapter_id)))

    def observe_finish(self, now: float, residence: float) -> None:
        """``residence`` = finish - arrival of a completed request; feeds
        the Little's-law concurrency estimate."""
        self._residences.append((now, max(float(residence), 0.0)))

    def _prune(self, now: float) -> None:
        horizon = now - self.policy.window
        while self._arrivals and self._arrivals[0][0] < horizon:
            self._arrivals.popleft()
        while self._residences and self._residences[0][0] < horizon:
            self._residences.popleft()

    def rate(self, now: float) -> float:
        """Arrivals per second over the (possibly still-filling) window."""
        self._prune(now)
        if not self._arrivals or self._t0 is None:
            return 0.0
        span = min(self.policy.window, max(now - self._t0, 1e-9))
        return len(self._arrivals) / max(span, 1e-9)

    def popularity(self, n_adapters: int) -> np.ndarray:
        """Empirical invocation probabilities over the window (+1 smoothing
        so unseen adapters keep a nonzero share — they can still arrive)."""
        counts = np.ones(n_adapters)
        for _, aid in self._arrivals:
            if 0 <= aid < n_adapters:
                counts[aid] += 1.0
        return counts / counts.sum()

    # ------------------------------- control --------------------------- #
    def due(self, now: float) -> bool:
        return now >= self._next_control

    def _hysteresis(self, dim: str, current: int, target: int) -> int:
        """Immediate scale-up; scale-down only after ``scale_down_patience``
        consecutive low readings."""
        if target >= current:
            self._low_streak[dim] = 0
            return target
        self._low_streak[dim] += 1
        if self._low_streak[dim] >= self.policy.scale_down_patience:
            self._low_streak[dim] = 0
            return target
        return current

    def control(self, now: float, *, in_flight: int, queued: int,
                cache_slots: int, n_instances: int,
                n_replicas: int,
                host_hit_rate: Optional[float] = None,
                miss_cost_ratio: float = 1.0,
                mean_active_rank: Optional[float] = None
                ) -> List[ScaleAction]:
        """One Algorithm-1 evaluation over the live window; returns the
        actions that converge the system to the new targets (empty when
        nothing changes or the interval has not elapsed).

        ``host_hit_rate``/``miss_cost_ratio`` feed the second-tier derate:
        Algorithm 1's cache-size equation assumes every miss is a cold
        start, but with a host-RAM tier a fraction ``h`` of misses only
        pays ``ratio`` (= c_host / c_disk <= 1) of the worst-case penalty.
        The expected miss cost scales by f = h*ratio + (1-h), so the IAR
        target relaxes to alpha_eff = 1 - (1-alpha)/f: cheaper misses
        tolerate a higher miss RATE at the same TTFT damage, shrinking
        M*. ``host_hit_rate=None`` (no tier observations yet) keeps the
        cold-start model.

        ``mean_active_rank`` (the transport plane's effective-rank
        telemetry) prices the Eqs. 5-6 server compute term at the rank
        the rank-aware kernels actually pay instead of the padded pool
        rank; None (no observations / rank-aware off) keeps the padded
        model."""
        pol = self.policy
        if not self.due(now):
            return []
        alpha_eff = pol.alpha
        if host_hit_rate is not None:
            f = float(np.clip(host_hit_rate * miss_cost_ratio
                              + (1.0 - host_hit_rate), 1e-3, 1.0))
            alpha_eff = max(1.0 - (1.0 - pol.alpha) / f, 0.0)
        self._next_control = now + pol.control_interval
        self._prune(now)
        rate = self.rate(now)

        # lookback batch LB: direct backlog, or Little's law when the
        # window has finishers (rate x mean residence = steady concurrency)
        lb = max(1, in_flight + queued)
        if self._residences and rate > 0:
            mean_res = float(np.mean([r for _, r in self._residences]))
            lb = max(lb, int(math.ceil(rate * mean_res)))

        # expected distinct adapters in a lookback batch (Poissonized):
        # feeds both the TPOT model and the cache floor
        seen = sorted({aid for _, aid in self._arrivals})
        probs = self.popularity(max(seen[-1] + 1, 2) if seen else 2)
        distinct = float(np.sum(1.0 - np.exp(-lb * probs)))

        # TTFT side (Eqs. 1-4): minimum cache with IAR >= alpha over the
        # adapters actually seen in the window. Floor: every DISTINCT
        # in-flight adapter holds a pinned (unevictable) slot for its whole
        # residence, so the cache must cover the expected concurrent
        # distinct set with headroom or admission blocks on pins — a
        # constraint the offline Poisson residency model does not see.
        achieved_iar = 1.0
        if len(seen) > 1:
            counts = np.array([sum(1 for _, a in self._arrivals if a == s)
                               for s in seen], float)
            p_seen = counts / counts.sum()
            m_star = min_cache_size(p_seen, lb, alpha_eff)
        else:
            m_star = pol.min_cache_slots
        cache_t = int(np.clip(max(m_star, math.ceil(1.2 * distinct)),
                              pol.min_cache_slots, pol.max_cache_slots))
        if len(seen) > 1:
            achieved_iar = iar(p_seen, lb, min(cache_t, len(seen)))

        # LLM instances: concurrency demand over per-instance batch slots,
        # derated so the fleet sits at target_utilization, not saturation
        slots_eff = max(self.max_batch * pol.target_utilization, 1.0)
        inst_t = int(np.clip(math.ceil(lb / slots_eff),
                             pol.min_instances, pol.max_instances))

        # TPOT side (Eqs. 5-6): server chips for the expected distinct
        # adapters per batch, lifted to whole replicas
        gpus = 0
        rep_t = n_replicas
        if self.has_server:
            b_est = max(1, math.ceil(lb / inst_t))
            # the transport plane's host launch tail is spent BEFORE any
            # server round trip: derate the TPOT budget by it so the
            # capacity equation provisions for what is actually left
            launch = cost_model.transport_dispatch_seconds(
                self.cfg.n_layers, n_replicas, self.transport,
                self.hook_launch_us)
            slo_eff = max(pol.slo_tpot - launch, 0.2 * pol.slo_tpot)
            gpus, _, _ = min_gpus_for_tpot(
                self.cfg, b_est, self.gpus_per_instance, inst_t,
                slo_eff, distinct, hw=self.hw,
                max_m=pol.max_replicas * pol.gpus_per_replica,
                rank=mean_active_rank)
            rep_t = int(np.clip(math.ceil(gpus / pol.gpus_per_replica),
                                pol.min_replicas, pol.max_replicas))

        if abs(cache_t - cache_slots) <= pol.resize_deadband * cache_slots:
            cache_t = cache_slots
        cache_t = self._hysteresis("cache", cache_slots, cache_t)
        inst_t = self._hysteresis("instances", n_instances, inst_t)
        rep_t = self._hysteresis("replicas", n_replicas, rep_t)

        actions: List[ScaleAction] = []
        if cache_t != cache_slots:
            actions.append(ScaleAction(
                "resize_cache", cache_t,
                f"IAR>={pol.alpha} at LB={lb} needs M*={cache_t}"))
        if inst_t > n_instances:
            actions.append(ScaleAction(
                "add_instance", inst_t, f"LB={lb} over {self.max_batch} "
                f"slots/instance"))
        elif inst_t < n_instances:
            actions.append(ScaleAction(
                "drain_instance", inst_t, f"LB={lb} fits {inst_t} "
                f"instances"))
        if rep_t > n_replicas:
            actions.append(ScaleAction(
                "add_replica", rep_t,
                f"TPOT<={pol.slo_tpot}s needs {gpus} server chips"))
        elif rep_t < n_replicas:
            actions.append(ScaleAction("remove_replica", rep_t,
                                       f"{gpus} server chips suffice"))
        self.history.append({
            "now": now, "rate": rate, "lb": lb,
            "iar": round(float(achieved_iar), 4),
            "alpha_eff": round(float(alpha_eff), 4),
            "host_hit_rate": (round(float(host_hit_rate), 4)
                              if host_hit_rate is not None else None),
            "mean_active_rank": (round(float(mean_active_rank), 3)
                                 if mean_active_rank is not None else None),
            "targets": {"cache_slots": cache_t, "instances": inst_t,
                        "replicas": rep_t},
            "actions": [(a.kind, a.target) for a in actions],
        })
        return actions
