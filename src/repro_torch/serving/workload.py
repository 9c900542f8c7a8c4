"""Multi-tenant workload generation (paper §6.1), a copy of
``repro.serving.workload`` (the port imports nothing of the JAX package).

Adapter popularity: Zipf(s=1.2) over N adapters (calibrated to production
traces in the paper's [53]). Arrivals: Poisson with configurable rate.
Input/output lengths: BurstGPT-shaped lognormals (the paper samples from
BurstGPT [37]; we match its reported token-count scales).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    adapter_id: int
    arrival: float
    prompt_len: int
    output_len: int
    prompt: tuple = ()           # optional real token ids (the cluster)
    # runtime (filled by the simulator / engine)
    instance: int = -1
    decode_start: float = -1.0   # first decode step admitted
    first_token: float = -1.0
    finish: float = -1.0
    tokens_done: int = 0
    reserved: bool = False       # holds a pinned (possibly loading) slot
    cancelled: bool = False      # client gave up; never counts as finished

    @property
    def ttft(self) -> float:
        """Paper footnote 1: queueing delay + first decode token (prefill
        excluded under PD disaggregation). A request that never received a
        first token has UNBOUNDED ttft (first_token stays -1.0; subtracting
        would yield a negative, better-than-perfect latency)."""
        if self.first_token < 0:
            return float("inf")
        return self.first_token - self.arrival

    @property
    def tpot(self) -> float:
        if self.output_len <= 1 or self.finish < 0:
            return 0.0
        if self.first_token < 0:    # finished without a first-token stamp:
            return float("inf")     # corrupt bookkeeping, never a real TPOT
        return (self.finish - self.first_token) / max(self.output_len - 1, 1)


def zipf_popularity(n_adapters: int, s: float = 1.2) -> np.ndarray:
    w = 1.0 / np.arange(1, n_adapters + 1) ** s
    return w / w.sum()


def generate_load_shift(n_adapters: int, lo_rate: float, hi_rate: float,
                        t_shift: float, duration: float,
                        seed_lo: int = 1, seed_hi: int = 2) -> List[Request]:
    """Two-phase Poisson workload: ``lo_rate`` until ``t_shift``, then
    ``hi_rate`` until ``duration`` — the traffic step the elastic-
    provisioning benchmark, example, and tests all share (one definition,
    so the scenario they cite cannot silently diverge)."""
    lo = generate(n_adapters, rate=lo_rate, duration=t_shift, seed=seed_lo)
    hi = generate(n_adapters, rate=hi_rate, duration=duration - t_shift,
                  seed=seed_hi)
    for r in hi:
        r.rid += 10_000
        r.arrival += t_shift
    return lo + hi


def generate(n_adapters: int, rate: float, duration: float,
             zipf_s: float = 1.2, seed: int = 0,
             mean_prompt: int = 512, mean_output: int = 192,
             shuffle_popularity: bool = True) -> List[Request]:
    """Poisson arrivals at ``rate`` req/s for ``duration`` seconds."""
    rng = np.random.default_rng(seed)
    probs = zipf_popularity(n_adapters, zipf_s)
    adapter_perm = (rng.permutation(n_adapters) if shuffle_popularity
                    else np.arange(n_adapters))
    t = 0.0
    out: List[Request] = []
    rid = 0
    while True:
        t += rng.exponential(1.0 / rate)
        if t > duration:
            break
        pop_idx = rng.choice(n_adapters, p=probs)
        prompt = int(np.clip(rng.lognormal(np.log(mean_prompt), 0.9), 8, 8192))
        output = int(np.clip(rng.lognormal(np.log(mean_output), 0.7), 4, 2048))
        out.append(Request(rid, int(adapter_perm[pop_idx]), t, prompt, output))
        rid += 1
    return out
