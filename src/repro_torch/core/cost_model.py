"""Analytical cost model for LoRA-Server parallelization (paper §4.1
Table 1 and appendix A.2.1), the counterpart of ``repro.core.cost_model``
priced with a nominal H100 (``H100``) by default.

Note on Table 1: the paper's table as typeset scrambles some fractions; the
prose of §4.1 is self-consistent (all strategies are the x,y-specializations
of hybrid), so the model implements the prose:

  DP        : vol bk/(p·m)   peers p            compute bk/m   sync m
  PP        : vol bk/p       peers p            compute bk     sync 1
  EP        : vol bk/max(p,m) peers max(p/m,1)  compute bk/m   sync m
  EP_x-PP_y : vol bk/max(p,x) peers max(p/x,1)  compute bk/x   sync x

(EP == hybrid(x=m,y=1), PP == hybrid(x=1,y=m).)

Latency model (per MoE layer, both hook points): LoRA compute is
memory-bound and driven by *distinct* adapter invocations (paper A.1.2);
communication is link-bound and linear in rows. The model prices
placements analytically; ``chip_smoke.py`` phase 8 prints its constants
and predictions beside what the card measures.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.core.placement import Placement


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One accelerator of the serving cluster. The defaults are a NOMINAL
    NVIDIA H100 SXM5 (80 GB) from NVIDIA's data sheet, not measurements:
    ``ici`` is the intra-node link (NVLink 4 through NVSwitch, per
    direction), ``dcn`` the inter-node link (one 400 Gb/s ConnectX-7 NIC),
    ``host`` the host -> device path (PCIe Gen5 x16, per direction) and
    ``disk`` the adapter store's second miss tier."""
    flops: float = 989e12          # dense bf16 tensor-core FLOP/s
    hbm_bw: float = 3.35e12        # HBM3, B/s
    ici_bw: float = 450e9          # NVLink 4 via NVSwitch, B/s a direction
    dcn_bw: float = 50e9           # one 400 Gb/s NIC, B/s
    # no data-sheet number for either latency: both are the reference
    # cost model's per-transfer latencies, kept until the port measures
    # its own
    ici_lat: float = 1e-6          # s per one-sided intra-node transfer
    dcn_lat: float = 10e-6         # s per one-sided inter-node transfer
    host_bw: float = 64e9          # PCIe Gen5 x16, B/s a direction
    disk_bw: float = 5e9           # disk -> host RAM (NVMe-class, as the
    #                                reference)
    hbm_gb: float = 80.0

    def link(self, inter_pod: bool):
        return (self.dcn_bw, self.dcn_lat) if inter_pod else \
            (self.ici_bw, self.ici_lat)


H100 = Hardware()


def strategy_metrics(strategy: str, b: int, k: int, p: int, m: int,
                     x: int = 1, y: int = 1) -> Dict[str, float]:
    """Paper Table 1 (prose form). Units: rows of activations per layer."""
    bk = b * max(k, 1)
    if strategy == "dp":
        return {"peer_volume": bk / (p * m), "peer_count": p,
                "compute_volume": bk / m, "sync_scope": m}
    if strategy == "pp":
        x, y = 1, m
    elif strategy == "ep":
        x, y = m, 1
    elif strategy == "hybrid":
        if x * y != m:
            raise ValueError(f"hybrid needs x * y == m, got {x} * {y} != "
                             f"{m}")
    else:
        raise ValueError(strategy)
    return {"peer_volume": bk / max(p, x), "peer_count": max(p // x, 1),
            "compute_volume": bk / x, "sync_scope": x}


def payload_bytes(cfg: ModelConfig, rows: float, dtype_bytes: int = 2):
    """Per-layer client->server and server->client bytes for ``rows``
    (token, expert) activations across both hook points (Fig. 7b)."""
    d, ff = cfg.d_model, cfg.d_ff
    send = rows * (d + ff) * dtype_bytes           # x rows + h rows
    n_up = 2 if cfg.gated_mlp else 1
    recv = rows * (n_up * ff + d) * dtype_bytes    # gate/up deltas + down delta
    return send, recv


def lora_compute_seconds(cfg: ModelConfig, rows: float, distinct: float,
                         rank: int, hw: Hardware = H100,
                         kernel_eff: float = 0.7) -> float:
    """Per-device LoRA compute for one layer's hooks: max(flops, HBM) with
    the distinct-adapter weight traffic the paper identifies as dominant."""
    d, ff = cfg.d_model, cfg.d_ff
    n_up = 2 if cfg.gated_mlp else 1
    flops = 2.0 * rows * rank * ((1 + n_up) * (d + ff))
    act_bytes = rows * (d + ff) * 2 * 2  # read rows + write deltas
    w_bytes = distinct * (n_up * (d + ff) + (ff + d)) * rank * 2
    t_flops = flops / (hw.flops * kernel_eff)
    t_mem = (act_bytes + w_bytes) / (hw.hbm_bw * kernel_eff)
    return max(t_flops, t_mem)


def latency_breakdown(cfg: ModelConfig, placement: Placement, b: int, p: int,
                      distinct_adapters: float, rank: int = None,
                      hw: Hardware = H100, inter_pod: bool = False,
                      protocol: str = "push") -> Dict[str, float]:
    """(T_recv, T_comp, T_send) per layer for one LLM instance (Eq. 5
    terms)."""
    from repro_torch.core.protocol import transfer_seconds
    k = max(cfg.top_k, 1)
    rank = rank or cfg.lora_rank
    met = strategy_metrics(
        placement.strategy, b, k, p, placement.m, placement.x, placement.y)
    rows_dev = met["compute_volume"]
    send_b, recv_b = payload_bytes(cfg, rows_dev)
    t_recv = transfer_seconds(send_b, hw, inter_pod, protocol,
                              peers=met["peer_count"],
                              sync_scope=met["sync_scope"])
    t_send = transfer_seconds(recv_b, hw, inter_pod, protocol,
                              peers=met["peer_count"],
                              sync_scope=met["sync_scope"])
    # distinct (adapter, expert) weight blocks read per device: every row
    # touches exactly one block and shared blocks amortize, so it is capped
    # by rows; spread over the placement's expert shards
    E = max(cfg.n_experts, 1)
    dist_dev = min(distinct_adapters * E / placement.m, rows_dev)
    t_comp = lora_compute_seconds(cfg, rows_dev, dist_dev, rank, hw)
    return {"recv": t_recv, "comp": t_comp, "send": t_send,
            **{f"m_{k_}": v for k_, v in met.items()}}


def transport_dispatch_seconds(n_layers: int, n_replicas: int,
                               transport: str = "host",
                               hook_launch_us: float = 0.0) -> float:
    """Per-decode-step host launch tail of the hook transport plane.

    Host-mediated dispatch pays 2 x n_layers hook calls a step, each
    engaging up to every server replica, plus the gather/scatter/select
    overhead launches (the upper bound of ``HostTransport``'s measured
    ledger: one launch per engaged replica per hook). The fused plane
    launches ONE program (a CUDA graph replay) a step whatever the depth or
    replica count. ``hook_launch_us`` is the per-launch cost; the default
    0 keeps the reference's calibration (launch cost folded into the
    simulator's ``step_overhead``)."""
    if hook_launch_us <= 0:
        return 0.0
    if transport == "fused":
        return hook_launch_us * 1e-6
    return (2 * n_layers * max(n_replicas, 1) + 3) * hook_launch_us * 1e-6


def base_moe_gemm_seconds(cfg: ModelConfig, b: int, p: int,
                          hw: Hardware = H100, eff: float = 0.5) -> float:
    """Base model's grouped-GEMM time per MoE layer per instance (the budget
    LoRA must hide under, Eq. 5's SLO_FFN reference point)."""
    d, ff, k = cfg.d_model, cfg.d_ff, max(cfg.top_k, 1)
    n_mats = 3 if cfg.gated_mlp else 2
    flops = 2.0 * b * k * n_mats * d * ff
    w_bytes = min(b * k, cfg.n_experts or 1) * n_mats * d * ff * 2
    return max(flops / (hw.flops * eff), w_bytes / hw.hbm_bw) / p
