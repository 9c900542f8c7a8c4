"""Serving entry point of the port: multi-LoRA decode through the slot
engine, disaggregated (the LoRA Server computes the MoE hooks' deltas) or
coupled (the S-LoRA baseline: adapters applied inside the model), over a
paged KV pool or, with ``--dense``, a dense slab. The disaggregated plane
runs over a pool of ``--replicas`` LoRA-Server replicas through the
``--transport`` plane: "host" (per-hook host dispatch) or "fused" (one
CUDA graph a decode step).

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-235b-a22b --layers 4 --requests 6 --mode coupled
  PYTHONPATH=src python -m repro_torch.launch.serve --transport fused \
      --replicas 2

Weights and adapters are random, drawn on the device from ``--seed``;
nothing is downloaded. Requests arrive in two waves, so the second wave is
admitted into a running batch. Runs on the CUDA card unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.adapter import init_mixed_rank_pool
from repro_torch.core.lora_server import pool_tensors_from_adapter
from repro_torch.models.model import init_params, resolve_device, resolve_dtype
from repro_torch.obs.clock import wall_time
from repro_torch.serving.cache import LoRACache
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.server_pool import ServerPool

FFN_TARGETS = ("gate", "up", "down")
MODES = ("disagg", "coupled")
TRANSPORTS = ("host", "fused")


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


def build_lora(cfg, mode: str, adapter_ranks: Sequence[int], seed: int = 0,
               dtype=torch.bfloat16, device=None, replicas: int = 1) -> Dict:
    """One mixed-rank pool of adapters (ids 0..N-1), served by one plane;
    returns the Engine's keyword arguments for it.

    disagg : ``build_pool``'s pool of ``replicas`` LoRA-Server replicas
             holding every adapter of the expert-FFN targets (the hooks
             they serve) -> {"server", "pool"}
    coupled: the pool over all of the config's targets -> {"pool"}

    The pool rank, and the servers', is the largest true rank."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    if mode == "disagg":
        return build_pool(cfg, adapter_ranks, replicas, seed=seed,
                          dtype=dtype, device=device)
    return {"pool": init_mixed_rank_pool(cfg, adapter_ranks, seed=seed + 1,
                                         dtype=dtype, device=device)}


def build_pool(cfg, adapter_ranks: Sequence[int], replicas: int = 1,
               cache_slots: Optional[int] = None, seed: int = 0,
               dtype=torch.bfloat16, device=None) -> Dict:
    """The disaggregated plane over an elastic pool: ``replicas``
    LoRA-Server replicas of ``cache_slots`` slots each (default: one per
    adapter) and the mixed-rank pool of the FFN targets they serve, drawn
    from ``seed`` as ``build_lora``'s coupled pool is; returns the Engine's
    keyword arguments {"server", "pool"}. With the default slots every
    adapter is resident; with fewer none is, and a ``Residency`` over the
    two brings them in as requests need them."""
    pool = init_mixed_rank_pool(
        dataclasses.replace(cfg, lora_targets=FFN_TARGETS), adapter_ranks,
        seed=seed + 1, dtype=dtype, device=device)
    slots = cache_slots or pool.n
    sp = ServerPool.build(cfg, pool, cache_slots=slots, n_replicas=replicas,
                          dtype=dtype, device=device)
    if cache_slots is None:
        res = Residency(sp, pool, slots)
        for aid in range(pool.n):
            res.acquire(aid)
            res.release(aid)
        res.sync()
    return {"server": sp, "pool": pool}


class Residency:
    """A LoRA cache (``LoRACache``, LRU among unpinned residents) in front
    of a ``ServerPool``, the control plane the reference's cluster runs:
    a request is admitted only once its adapter is resident (pinned while
    it runs), and before every decode step the replicas' slot tables
    follow the cache (delta ``ServerPool.sync``). Works over the reference
    package's cache and pool too: they have the same methods."""

    def __init__(self, server_pool, adapter_pool, capacity: int,
                 cache=None, tensors_fn: Optional[Callable] = None):
        self.pool = server_pool
        self.cache = cache if cache is not None else LoRACache(
            capacity, adapter_bytes=0, n_layers=adapter_pool.cfg.n_layers,
            layerwise=False, prefetch=False)
        self.tensors_fn = tensors_fn or (
            lambda a: pool_tensors_from_adapter(adapter_pool, a))
        self.rank_fn = adapter_pool.rank_of
        self.clock = 0.0        # one tick a decode step (the LRU's time)

    def acquire(self, adapter_id: int) -> bool:
        if self.cache.admit(adapter_id, self.clock) is None:
            return False
        self.cache.pin(adapter_id)
        return True

    def release(self, adapter_id: int) -> None:
        self.cache.unpin(adapter_id, self.clock)

    def sync(self) -> int:
        self.clock += 1.0
        return self.pool.sync(self.cache, self.tensors_fn, self.rank_fn)


def serve(engine: Engine, requests, traffic: Traffic,
          residency: Optional[Residency] = None) -> Dict:
    """Run ``requests`` through ``engine`` in two waves; every request
    takes ``traffic.new_tokens`` greedy tokens. With a ``residency``, a
    request waits (in arrival order) until its adapter is resident, and the
    server pool follows the cache before every step. Returns tokens per rid
    and the run's counts and host-clock times (each step ends in a device
    sync: its tokens come back to the host)."""
    tokens: Dict[int, List[int]] = {rid: [] for rid, _, _ in requests}
    pending = list(requests)
    waiting: List = []
    adapter_of = {rid: aid for rid, _, aid in requests}
    prefill_s = decode_s = 0.0
    steps = 0
    bucket_rows = []

    def admit():
        nonlocal prefill_s
        t0 = wall_time()
        while waiting and engine.free_slots() and (
                residency is None or residency.acquire(waiting[0][2])):
            rid, prompt, aid = waiting.pop(0)
            engine.add_request(rid, prompt, aid)
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        prefill_s += wall_time() - t0

    waiting += pending[: traffic.first_wave]
    pending = pending[traffic.first_wave:]
    admit()
    while pending or waiting or engine.active_rids():
        if pending and (steps >= traffic.second_wave_after
                        or not engine.active_rids()):
            waiting += pending
            pending = []
        if waiting:
            admit()
        if not engine.active_rids():
            raise RuntimeError("no request could be admitted")
        if residency is not None:
            residency.sync()
        bucket_rows.append(len(engine.active_rids()))
        t0 = wall_time()
        out = engine.step()
        decode_s += wall_time() - t0
        steps += 1
        for rid, t in out.items():
            tokens[rid].append(t)
            if len(tokens[rid]) == traffic.new_tokens:
                engine.evict_request(rid)
                if residency is not None:
                    residency.release(adapter_of[rid])
    n_tok = sum(len(v) for v in tokens.values())
    return {"tokens": tokens, "decode_steps": steps, "rows_per_step":
            bucket_rows, "generated_tokens": n_tok, "prefill_s": prefill_s,
            "prefill_chunks": engine.prefill_chunks,
            "decode_s": decode_s,
            "decode_ms_per_step": 1e3 * decode_s / max(steps, 1),
            "tokens_per_s": n_tok / decode_s if decode_s else 0.0}


def build(arch: str, *, layers: Optional[int] = None, reduced: bool = False,
          seed: int = 0, device=None, traffic: Traffic = Traffic(),
          mode: str = "disagg", paged: bool = True, replicas: int = 1):
    """(cfg, params, lora, engine config) for one run, where ``lora`` is
    the Engine's keyword arguments of the ``mode``'s plane (``build_lora``;
    disagg: ``replicas`` server replicas): 8 slots of up to 256 tokens, in
    pages of 16 or a dense slab, prefill chunks of 64."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dev = resolve_device(device)
    dt = resolve_dtype(cfg.dtype)
    params = init_params(cfg, seed=seed, dtype=dt, device=dev)
    lora = build_lora(cfg, mode, traffic.adapter_ranks, seed=seed,
                      dtype=dt, device=dev, replicas=replicas)
    ecfg = EngineConfig(max_len=256, n_slots=8, paged=paged, page_size=16,
                        prefill_chunk=64)
    return cfg, params, lora, ecfg


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
    ap.add_argument("--mode", default="disagg", choices=MODES,
                    help="disagg: LoRA Server hooks; coupled: adapters in "
                         "the model (S-LoRA)")
    ap.add_argument("--dense", action="store_true",
                    help="dense KV slab instead of the paged pool")
    ap.add_argument("--transport", default="host", choices=TRANSPORTS,
                    help="disagg: host (per-hook dispatch) or fused (one "
                         "CUDA graph a decode step)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="disagg: LoRA-Server replicas of the pool")
    args = ap.parse_args(argv)
    traffic = dataclasses.replace(Traffic(), n_requests=args.requests)
    if args.reduced:
        traffic = dataclasses.replace(traffic, prompt_len=(6, 20),
                                      new_tokens=6, second_wave_after=2)
    cfg, params, lora, ecfg = build(
        args.arch, layers=args.layers, reduced=args.reduced, seed=args.seed,
        device=args.device, traffic=traffic, mode=args.mode,
        paged=not args.dense, replicas=args.replicas)
    engine = Engine(cfg, params, ecfg, device=args.device,
                    transport=args.transport, **lora)
    res = serve(engine, make_requests(cfg, traffic, args.seed), traffic)
    print(json.dumps({"mode": args.mode, "paged": ecfg.paged,
                      **{k: v for k, v in res.items() if k != "tokens"}}))
    print(json.dumps({"kv_stats": engine.kv_stats(),
                      "transport": engine.transport_stats()}))
    print("generated:", {rid: t for rid, t in res["tokens"].items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
