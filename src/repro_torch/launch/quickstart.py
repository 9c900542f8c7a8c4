"""Quickstart of the port: multi-LoRA serving of a tiny model through the
front door (``repro_torch.serving.api``), the counterpart of
``examples/quickstart.py``.

Builds the reduced config of ``--arch`` (default Qwen3-MoE) and a pool of
LoRA adapters, then submits requests, each with its own adapter, to a
``ServeSystem``: for a MoE arch on the main path (adapters on the expert
FFN, disaggregated LoRA Server, paged KV, the fused transport), for a
dense or vlm arch on the coupled plane (adapters on all its targets, paged
KV): continuous batching, per-token streaming, and a cancellation
mid-decode, all from ``submit()`` handles.

    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu \
        --arch qwen2-1.5b
    PYTHONPATH=src python -m repro_torch.launch.quickstart   # on the card
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.core.adapter import init_adapter_pool
from repro_torch.models.model import init_params
from repro_torch.serving.api import ServeConfig, build_system


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="qwen3-moe-235b-a22b",
                    choices=list_archs(assigned_only=False))
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).reduced()
    disagg = cfg.is_moe
    cfg = dataclasses.replace(cfg, lora_rank=4, lora_targets=(
        ("gate", "up", "down") if disagg else cfg.lora_targets))
    ffn = (f"{cfg.n_experts} experts top-{cfg.top_k}" if disagg
           else f"{cfg.family} MLP")
    print(f"model: {cfg.name} ({cfg.n_layers} layers, d={cfg.d_model}, "
          f"{ffn}) on {args.device}")
    params = init_params(cfg, seed=0, device=args.device)
    pool = init_adapter_pool(cfg, 4, seed=1, rank=4, device=args.device)
    print(f"adapter pool: 4 adapters x {pool.bytes_per_adapter() / 1e6:.2f}"
          f" MB")

    system = build_system(
        ServeConfig(backend="cluster", disaggregated=disagg, paged=True,
                    transport="fused", n_instances=1, max_batch=4,
                    max_len=48, adapter_cache_slots=4),
        cfg, params=params, pool=pool)
    try:
        # one shared prompt, four adapters: each request's adapter steers
        # its decoding
        rng = np.random.default_rng(0)
        prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 8)]
        handles = [system.submit(prompt, adapter_id=a, max_new_tokens=8)
                   for a in range(4)]

        # stream adapter 0's tokens as they decode (the others run along)
        print("adapter 0 streams:", end=" ", flush=True)
        for tok in handles[0]:
            print(tok, end=" ", flush=True)
        print()

        system.drain()
        for h in handles:
            print(f"  adapter {h.request.adapter_id}: {h.tokens}  "
                  f"[{h.state.name.lower()}]")
        rows = np.array([h.tokens for h in handles])
        diff = int((rows != rows[0]).sum())
        print(f"{diff} / {rows.size} tokens differ across per-request "
              f"adapters")
        print(f"transport: {system.transport_stats()}")

        # cancellation: give up on a request mid-decode; its slot frees
        h = system.submit(prompt, adapter_id=1, max_new_tokens=12)
        while h.n_tokens < 3:
            system.step()
        h.cancel()
        system.drain()
        print(f"cancelled rid={h.rid} after {h.n_tokens} tokens "
              f"[{h.state.name.lower()}]; slots in use: "
              f"{system.kv_stats()[0]['slots_in_use']}")
    finally:
        system.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
