"""Serving entry point of the port: disaggregated multi-LoRA decode
through the paged slot engine, with the LoRA Server's hooks computed on
the card.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-235b-a22b --layers 4 --requests 6

Weights and adapters are random, drawn on the device from ``--seed``;
nothing is downloaded. Requests arrive in two waves, so the second wave is
admitted into a running batch. Runs on the CUDA card unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.adapter import init_mixed_rank_pool
from repro_torch.core.lora_server import (LoRAServer, ServerConfig,
                                          pool_tensors_from_adapter)
from repro_torch.models.model import init_params, resolve_device, resolve_dtype
from repro_torch.obs.clock import wall_time
from repro_torch.serving.engine import Engine, EngineConfig

FFN_TARGETS = ("gate", "up", "down")


@dataclasses.dataclass(frozen=True)
class Traffic:
    """The request mix: prompt lengths drawn uniformly from ``prompt_len``,
    adapters assigned round-robin, ``first_wave`` requests admitted at the
    start and the rest after ``second_wave_after`` decode steps."""
    n_requests: int = 6
    adapter_ranks: Tuple[int, ...] = (8, 16, 32, 32)
    prompt_len: Tuple[int, int] = (96, 200)
    new_tokens: int = 24
    first_wave: int = 4
    second_wave_after: int = 8


def make_requests(cfg, traffic: Traffic, seed: int = 0):
    """[(rid, prompt token list, adapter id)] from ``seed``."""
    rng = np.random.default_rng(seed)
    lo, hi = traffic.prompt_len
    n_adapters = len(traffic.adapter_ranks)
    return [(rid, rng.integers(0, cfg.vocab_size,
                               int(rng.integers(lo, hi + 1))).tolist(),
             rid % n_adapters)
            for rid in range(traffic.n_requests)]


def build_server(cfg, adapter_ranks: Sequence[int], seed: int = 0,
                 dtype=torch.bfloat16, device=None):
    """A LoRA Server holding one mixed-rank pool of adapters (ids 0..N-1)
    and the pool's scale. The pool rank is the model config's LoRA rank."""
    r = max(max(adapter_ranks), cfg.lora_rank)
    pool = init_mixed_rank_pool(
        dataclasses.replace(cfg, lora_targets=FFN_TARGETS), adapter_ranks,
        seed=seed + 1, dtype=dtype, device=device)
    server = LoRAServer(cfg, ServerConfig(m=1, x=1, y=1,
                                          cache_slots=len(adapter_ranks),
                                          rank=r),
                        dtype=dtype, device=device)
    for aid in range(pool.n):
        server.insert(aid, pool_tensors_from_adapter(pool, aid),
                      rank=pool.rank_of(aid))
    return server, pool.scale


def serve(engine: Engine, requests, traffic: Traffic) -> Dict:
    """Run ``requests`` through ``engine`` in two waves; every request
    takes ``traffic.new_tokens`` greedy tokens. Returns tokens per rid and
    the run's counts and host-clock times (each step ends in a device
    sync: its tokens come back to the host)."""
    tokens: Dict[int, List[int]] = {rid: [] for rid, _, _ in requests}
    pending = list(requests)
    prefill_s = decode_s = 0.0
    steps = 0
    bucket_rows = []

    def admit(batch):
        nonlocal prefill_s
        t0 = wall_time()
        for rid, prompt, aid in batch:
            engine.add_request(rid, prompt, aid)
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        prefill_s += wall_time() - t0

    admit(pending[: traffic.first_wave])
    pending = pending[traffic.first_wave:]
    while pending or engine.active_rids():
        if pending and (steps >= traffic.second_wave_after
                        or not engine.active_rids()):
            admit(pending)
            pending = []
        bucket_rows.append(len(engine.active_rids()))
        t0 = wall_time()
        out = engine.step()
        decode_s += wall_time() - t0
        steps += 1
        for rid, t in out.items():
            tokens[rid].append(t)
            if len(tokens[rid]) == traffic.new_tokens:
                engine.evict_request(rid)
    n_tok = sum(len(v) for v in tokens.values())
    return {"tokens": tokens, "decode_steps": steps, "rows_per_step":
            bucket_rows, "generated_tokens": n_tok, "prefill_s": prefill_s,
            "decode_s": decode_s,
            "decode_ms_per_step": 1e3 * decode_s / max(steps, 1),
            "tokens_per_s": n_tok / decode_s if decode_s else 0.0}


def build(arch: str, *, layers: Optional[int] = None, reduced: bool = False,
          seed: int = 0, device=None, traffic: Traffic = Traffic()):
    """(cfg, params, server, lora_scale, engine config) for one run: 8
    slots of up to 256 tokens in pages of 16, prefill chunks of 64."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dev = resolve_device(device)
    dt = resolve_dtype(cfg.dtype)
    params = init_params(cfg, seed=seed, dtype=dt, device=dev)
    server, scale = build_server(cfg, traffic.adapter_ranks, seed=seed,
                                 dtype=dt, device=dev)
    ecfg = EngineConfig(max_len=256, n_slots=8, page_size=16,
                        prefill_chunk=64)
    return cfg, params, server, scale, ecfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-235b-a22b")
    ap.add_argument("--layers", type=int, default=4,
                    help="model depth (cut: the full depth does not fit one "
                         "card)")
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny same-family config (CPU runs)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    traffic = dataclasses.replace(Traffic(), n_requests=args.requests)
    if args.reduced:
        traffic = dataclasses.replace(traffic, prompt_len=(6, 20),
                                      new_tokens=6, second_wave_after=2)
    cfg, params, server, scale, ecfg = build(
        args.arch, layers=args.layers, reduced=args.reduced, seed=args.seed,
        device=args.device, traffic=traffic)
    engine = Engine(cfg, params, ecfg, server, lora_scale=scale,
                    device=args.device)
    res = serve(engine, make_requests(cfg, traffic, args.seed), traffic)
    print(json.dumps({k: v for k, v in res.items() if k != "tokens"}))
    print(json.dumps({"kv_stats": engine.kv_stats()}))
    print("generated:", {rid: t for rid, t in res["tokens"].items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
