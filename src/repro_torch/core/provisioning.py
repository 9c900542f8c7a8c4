"""SLO-driven LoRA-Server resource provisioning (paper §4.2, Algorithm 1),
the counterpart of ``repro.core.provisioning`` computed in float64.

Tail-TTFT side: translate a P95 TTFT SLO into a target Immediate
Admissibility Rate alpha; model adapter residency with a Poissonized access
model; find the minimum cache size M* with IAR(M*) >= alpha.

  q_i(tau)   = Pr[Poisson(lam_i) > tau]          (Eq. 2, tau real-valued via
                                                  the regularized gamma)
  tau*       : solve sum_i q_i(tau*) = M          (Eq. 3, binary search)
  P_free(i)  = Pr[PoissonBinomial({q_j}_{j!=i}) <= M-1]   (DP, Alg. 1 l.7-14)
  IAR(M)     = sum_i p_i [q_i + (1-q_i) P_free(i)]        (Eq. 4)

The regularized gamma is ``torch.special.gammainc`` on float64 CPU
tensors (the reference's runs in float32, where IAR is not always monotone
in M); the binary search, the Poisson-binomial DP and the deconvolution are
float64 numpy, as in the reference.

Complexity: the paper's Algorithm 1 is O(N^3) per candidate M (a fresh
N-slot DP per adapter). It stays as ``iar_paper`` (the tests' oracle); the
default ``iar`` builds the Poisson-binomial DP over ALL adapters once, then
*deconvolves* adapter i out in O(N) with a numerically guarded
forward/backward recurrence: O(N^2). The M* search is binary (IAR is
monotone in M).

Average-TPOT side (Eqs. 5-6): profile T_recv/T_comp/T_send from the cost
model and find the minimum server GPU count + placement satisfying
  T_recv + T_comp + T_send <= SLO_FFN                       (Eq. 5)
  max(T_recv, T_comp, T_send) * L <= SLO_Layer              (Eq. 6)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cost_model
from repro_torch.core.cost_model import H100, Hardware
from repro_torch.core.placement import Placement


# ----------------------------- Eq. 2 / 3 -------------------------------- #
def zipf_probs(n: int, s: float = 1.2) -> np.ndarray:
    """Request-level invocation probabilities (paper workload, Zipf s=1.2)."""
    w = 1.0 / np.arange(1, n + 1) ** s
    return w / w.sum()


def residency_q(lams: np.ndarray, tau: float) -> np.ndarray:
    """q_i = Pr[Poisson(lam_i) > tau] for real tau >= 0 (Eq. 2), float64."""
    # Pr[X <= k] = Q(k+1, lam) (upper reg. gamma)  =>  Pr[X > k] = P(k+1, lam)
    lam = torch.from_numpy(np.maximum(np.asarray(lams, np.float64), 1e-12))
    a = torch.full_like(lam, float(tau) + 1.0)
    return torch.special.gammainc(a, lam).numpy()


def solve_tau(lams: np.ndarray, M: int, tol: float = 1e-10) -> float:
    """Binary-search tau* with sum_i q_i(tau*) = M (Eq. 3)."""
    lo, hi = 0.0, float(np.max(lams)) + 50.0 * math.sqrt(np.max(lams) + 1) + 50
    if residency_q(lams, lo).sum() <= M:
        return lo  # even tau=0 keeps fewer than M resident in expectation
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if residency_q(lams, mid).sum() > M:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol:
            break
    return 0.5 * (lo + hi)


# ------------------------- Poisson-binomial DP --------------------------- #
def poisson_binomial_pmf(qs: np.ndarray) -> np.ndarray:
    """dp[k] = Pr[sum Bernoulli(q_j) = k]; O(N^2)."""
    n = len(qs)
    dp = np.zeros(n + 1)
    dp[0] = 1.0
    for j, q in enumerate(qs):
        dp[1:j + 2] = dp[1:j + 2] * (1 - q) + dp[0:j + 1] * q
        dp[0] *= (1 - q)
    return dp


def _deconvolve(dp: np.ndarray, q: float) -> np.ndarray:
    """PMF of the sum with one Bernoulli(q) removed; O(N), guarded."""
    n = len(dp) - 1  # original count
    out = np.zeros(n)
    if q <= 0.5:
        # forward: dp[k] = out[k](1-q) + out[k-1] q
        prev = 0.0
        for k in range(n):
            prev = (dp[k] - q * prev) / (1 - q)
            out[k] = prev
    else:
        nxt = 0.0
        for k in range(n - 1, -1, -1):
            nxt = (dp[k + 1] - (1 - q) * nxt) / q
            out[k] = nxt
    return np.clip(out, 0.0, 1.0)


# ------------------------------ Eq. 4 ----------------------------------- #
def iar(probs: np.ndarray, LB: int, M: int) -> float:
    """Fast O(N^2) IAR(M) (deconvolution variant)."""
    N = len(probs)
    if M >= N:
        return 1.0
    lams = LB * probs
    tau = solve_tau(lams, M)
    qs = residency_q(lams, tau)
    dp_full = poisson_binomial_pmf(qs)
    total = 0.0
    for i in range(N):
        dp_wo = _deconvolve(dp_full, qs[i])
        p_free = dp_wo[:M].sum()
        total += probs[i] * (qs[i] + (1 - qs[i]) * min(p_free, 1.0))
    return float(total)


def iar_paper(probs: np.ndarray, LB: int, M: int) -> float:
    """Literal Algorithm 1 inner loop (O(N^3)); oracle for tests."""
    N = len(probs)
    if M >= N:
        return 1.0
    lams = LB * probs
    tau = solve_tau(lams, M)
    qs = residency_q(lams, tau)
    total = 0.0
    for i in range(N):
        dp = poisson_binomial_pmf(np.delete(qs, i))
        total += probs[i] * (qs[i] + (1 - qs[i]) * dp[:M].sum())
    return float(total)


def min_cache_size(probs: np.ndarray, LB: int, alpha: float = 0.95,
                   exact: bool = False) -> int:
    """M* = min{M : IAR(M) >= alpha} (Eq. 1) via binary search."""
    N = len(probs)
    f = iar_paper if exact else iar
    lo, hi = 1, N
    if f(probs, LB, hi) < alpha:
        return N  # even caching everything cannot (shouldn't happen: IAR(N)=1)
    while lo < hi:
        mid = (lo + hi) // 2
        if f(probs, LB, mid) >= alpha:
            hi = mid
        else:
            lo = mid + 1
    return lo


# --------------------------- Eqs. 5-6 (TPOT) ----------------------------- #
@dataclasses.dataclass
class ProvisionReport:
    M_star: int
    cache_bytes: int
    gpus_for_cache: int
    gpus_for_tpot: int
    gpus: int
    placement: Placement
    latency: Dict[str, float]
    iar: float


def min_gpus_for_tpot(cfg: ModelConfig, b: int, p: int, n_instances: int,
                      slo_tpot: float, distinct_adapters: float,
                      hw: Hardware = H100, ffn_share: float = 0.5,
                      max_m: int = 64,
                      rank: Optional[float] = None
                      ) -> Tuple[int, Placement, Dict]:
    """Smallest m (+ best EP_x-PP_y placement) satisfying Eqs. (5)-(6).

    ``rank`` prices the server-side compute term: the batch's observed
    mean EFFECTIVE rank under rank-aware kernels (each row bounded at its
    adapter's true rank), the padded pool rank when None."""
    slo_layer = slo_tpot / max(cfg.n_layers, 1)
    slo_ffn = slo_layer * ffn_share
    for m in range(1, max_m + 1):
        best = None
        for x in [d for d in range(1, m + 1) if m % d == 0]:
            pl = Placement.make("hybrid", m, 0, cfg.n_layers,
                                max(cfg.n_experts, 1), x=x)
            lat = cost_model.latency_breakdown(cfg, pl, b, p,
                                               distinct_adapters,
                                               rank=rank, hw=hw)
            t = (lat["recv"], lat["comp"], lat["send"])
            ok = (sum(t) <= slo_ffn) and (max(t) * n_instances <= slo_layer)
            if ok and (best is None or sum(t) < best[1]):
                best = (pl, sum(t), lat)
        if best is not None:
            return m, best[0], best[2]
    return max_m, Placement.make("hybrid", max_m, 0, cfg.n_layers,
                                 max(cfg.n_experts, 1)), {}


def provision(cfg: ModelConfig, n_adapters: int, n_instances: int, b: int,
              p: int, slo_tpot: float = 0.1, alpha: float = 0.95,
              zipf_s: float = 1.2, rank: Optional[int] = None,
              hw: Hardware = H100, hbm_lora_frac: float = 0.8,
              probs: Optional[np.ndarray] = None) -> ProvisionReport:
    """End-to-end §4.2: cache size from the TTFT side, GPU count from both."""
    probs = zipf_probs(n_adapters, zipf_s) if probs is None else probs
    LB = n_instances * b
    M_star = min_cache_size(probs, LB, alpha)
    a_bytes = cfg.lora_adapter_bytes(rank)
    cache_bytes = M_star * a_bytes
    per_gpu = hw.hbm_gb * 2**30 * hbm_lora_frac
    gpus_cache = max(1, math.ceil(cache_bytes / per_gpu))
    # distinct adapters expected in a global batch (used by the compute model)
    distinct = float(np.sum(1 - np.exp(-LB * probs)))
    gpus_tpot, placement, lat = min_gpus_for_tpot(
        cfg, b, p, n_instances, slo_tpot, distinct, hw=hw)
    m = max(gpus_cache, gpus_tpot)
    placement = Placement.make("hybrid", m, n_adapters, cfg.n_layers,
                               max(cfg.n_experts, 1),
                               x=placement.x if m % placement.x == 0 else None)
    return ProvisionReport(M_star, cache_bytes, gpus_cache, gpus_tpot, m,
                           placement, lat, iar(probs, LB, M_star))
