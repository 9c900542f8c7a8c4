"""S-LoRA coupled baseline (paper §6.1 'Methods Under Study'), a copy of
``repro.baselines.slora`` whose memory budgets default to the nominal
``H100``.

The coupled architecture shares ALL the substrate with InfiniLoRA (scheduler,
cache manager, workload, step-time model) — the ONLY differences are wiring:
per-instance adapter caches, adapters pre-assigned to instances by the greedy
balancer, and LoRA computed serially on the instance. These presets build the
three baseline variants of Fig. 11:

  slora            : 50/50 split of post-model memory between LoRA cache / KV
  slora_sjf        : + oracle shortest-job-first queueing
  slora_less_lora  : 40/60 split (smaller LoRA cache)

Cache slots are derived from the actual memory budget, like the paper does.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import H100, Hardware
from repro_torch.serving.simulator import SimConfig


def instance_cache_slots(cfg: ModelConfig, gpus: int, lora_frac: float,
                         hw: Hardware = H100,
                         rank: Optional[int] = None) -> int:
    """Paper: after loading base weights, split the REMAINING HBM between
    LoRA cache (lora_frac) and KV cache (1 - lora_frac)."""
    total = gpus * hw.hbm_gb * 2**30
    weights = 2 * cfg.param_count()
    free = max(total - weights, 0) * 0.9  # activation reserve
    return max(int(free * lora_frac // cfg.lora_adapter_bytes(rank)), 1)


def slora_config(cfg: ModelConfig, n_instances: int, gpus_per_instance: int,
                 n_adapters: int, duration: float = 300.0,
                 lora_frac: float = 0.5, sjf: bool = False,
                 max_batch: int = 128, hw: Hardware = H100) -> SimConfig:
    slots = instance_cache_slots(cfg, gpus_per_instance, lora_frac, hw)
    return SimConfig(
        n_instances=n_instances, gpus_per_instance=gpus_per_instance,
        max_batch=max_batch, duration=duration, disaggregated=False,
        instance_cache_slots=slots, n_adapters=n_adapters,
        policy="sjf" if sjf else "fcfs",
        # coupled baseline still gets fast kernels + layerwise loading — the
        # comparison isolates the ARCHITECTURE, as in the paper
        fast_kernels=True, layerwise_loading=True, hw=hw,
    )


def infinilora_config(cfg: ModelConfig, n_instances: int,
                      gpus_per_instance: int, server_gpus: int,
                      n_adapters: int, duration: float = 300.0,
                      placement_x: Optional[int] = None,
                      server_hbm_frac: float = 0.8, max_batch: int = 128,
                      hw: Hardware = H100,
                      rank: Optional[int] = None) -> SimConfig:
    slots = int(server_gpus * hw.hbm_gb * 2**30 * server_hbm_frac
                // cfg.lora_adapter_bytes(rank))
    return SimConfig(
        n_instances=n_instances, gpus_per_instance=gpus_per_instance,
        max_batch=max_batch, duration=duration, disaggregated=True,
        server_gpus=server_gpus, server_cache_slots=max(slots, 1),
        placement_x=placement_x or min(4, server_gpus),
        n_adapters=n_adapters, hw=hw,
    )
