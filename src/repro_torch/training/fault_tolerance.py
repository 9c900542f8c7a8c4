"""Fault tolerance & elasticity for 1000+-node operation (numpy only: the
reference's ``repro.training.fault_tolerance``, copied).

Three layers, all exercised by tests + the simulator:

1. Training restart: ``CheckpointManager`` (checkpoint.py) + deterministic
   data (data.py) make restart-resume exact; ``restore`` reshards onto the
   surviving mesh (elastic down-scale: fewer data shards, same model shards).

2. Serving failures: the simulator's fail/recover events exercise the REAL
   scheduler requeue path; recovery pays the weight-reload time. The
   ``HeartbeatMonitor`` here is the control-loop piece: it turns missed
   heartbeats into those events and drives re-provisioning.

3. Stragglers: per-worker step-time EWMA; workers slower than
   ``straggler_factor`` x median are flagged — serving steers admissions away
   (scheduler), training triggers elastic exclusion at the next checkpoint
   boundary (synchronous SPMD cannot drop a worker mid-step; the standard
   recipe is checkpoint -> reconfigure -> resume, which is what
   ``ElasticPlan`` emits).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class WorkerHealth:
    last_heartbeat: float = 0.0
    step_ewma: float = 0.0
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, n_workers: int, timeout: float = 10.0,
                 ewma_alpha: float = 0.2, straggler_factor: float = 2.0):
        self.workers = {i: WorkerHealth() for i in range(n_workers)}
        self.timeout = timeout
        self.alpha = ewma_alpha
        self.straggler_factor = straggler_factor

    def heartbeat(self, wid: int, now: float,
                  step_seconds: Optional[float] = None):
        w = self.workers[wid]
        w.last_heartbeat = now
        w.alive = True
        if step_seconds is not None:
            w.step_ewma = (step_seconds if w.step_ewma == 0 else
                           self.alpha * step_seconds +
                           (1 - self.alpha) * w.step_ewma)

    def check(self, now: float) -> Tuple[List[int], List[int]]:
        """-> (dead workers, stragglers)."""
        dead = [i for i, w in self.workers.items()
                if w.alive and now - w.last_heartbeat > self.timeout]
        for i in dead:
            self.workers[i].alive = False
        ewmas = [w.step_ewma for w in self.workers.values()
                 if w.alive and w.step_ewma > 0]
        stragglers = []
        if ewmas:
            med = float(np.median(ewmas))
            stragglers = [i for i, w in self.workers.items()
                          if w.alive and w.step_ewma > self.straggler_factor
                          * med]
        return dead, stragglers


@dataclasses.dataclass
class ElasticPlan:
    """Reconfiguration emitted on failure/straggler events."""
    surviving: List[int]
    new_data_shards: int
    resume_step: int
    reason: str


def plan_elastic_restart(n_workers: int, dead: List[int],
                         stragglers: List[int], data_shards: int,
                         checkpoint_step: int,
                         exclude_stragglers: bool = True) -> ElasticPlan:
    """Largest power-of-two data-parallel width over surviving workers
    (keeps global batch divisible; model shards are within-worker)."""
    bad = set(dead) | (set(stragglers) if exclude_stragglers else set())
    surviving = [i for i in range(n_workers) if i not in bad]
    width = 2 ** int(math.log2(max(len(surviving), 1)))
    reason = f"dead={dead} stragglers={stragglers if exclude_stragglers else []}"
    return ElasticPlan(surviving, min(width, data_shards), checkpoint_step,
                       reason)


def reprovision_on_workload_shift(provision_fn, observed_probs: np.ndarray,
                                  current_gpus: int, headroom: float = 0.15):
    """Serving elasticity (paper A.1.1): recompute Algorithm 1 with the
    OBSERVED adapter popularity; scale the LoRA Server when the answer moves
    outside the headroom band. Returns (new_gpus, report)."""
    report = provision_fn(observed_probs)
    need = report.gpus
    if need > current_gpus or need < current_gpus * (1 - headroom):
        return need, report
    return current_gpus, report
