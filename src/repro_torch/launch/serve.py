"""Serving entry point of the port: multi-LoRA decode through the front
door (``serving/api.py``: ``ServeConfig`` -> ``build_system`` ->
``submit``), disaggregated (the LoRA Server computes the MoE hooks'
deltas; MoE archs only) or coupled (the S-LoRA baseline: adapters applied
inside the model; any registered arch, dense and vlm included), over a
paged KV pool or, with ``--dense``, a dense slab. The
disaggregated plane runs over a pool of ``--replicas`` LoRA-Server
replicas through the ``--transport`` plane: "host" (per-hook host
dispatch) or "fused" (one CUDA graph a decode step).

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-235b-a22b --layers 4 --requests 6 --mode coupled
  PYTHONPATH=src python -m repro_torch.launch.serve --transport fused \
      --replicas 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \
      --mode coupled
  PYTHONPATH=src python -m repro_torch.launch.serve --cluster \
      --arch mixtral-8x7b --rate 25

Weights and adapters are random, drawn on the device from ``--seed``;
nothing is downloaded. Requests arrive in two waves, so the second wave is
admitted into a running batch. Runs on the CUDA card unless ``--device
cpu`` is given. ``serve`` drives one engine directly (the step timings of
``chip_smoke.py``). ``--cluster`` runs no model: it compares S-LoRA (4
instances, per-instance caches) with InfiniLoRA (3 instances and a LoRA
Server) at the full config on the analytic plane (``backend="sim"``),
priced with the nominal H100 constants: modelled numbers, not
measurements.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.baselines import slora as presets
from repro_torch.configs import get_config, list_archs
from repro_torch.core.adapter import init_mixed_rank_pool
from repro_torch.core.cost_model import H100, Hardware
from repro_torch.core.lora_server import pool_tensors_from_adapter
from repro_torch.models.model import init_params, resolve_device, resolve_dtype
from repro_torch.obs.clock import wall_time
from repro_torch.serving.api import ServeConfig, build_system
from repro_torch.serving.cache import LoRACache
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving import workload
from repro_torch.serving.server_pool import ServerPool

FFN_TARGETS = ("gate", "up", "down")
MODES = ("disagg", "coupled")
TRANSPORTS = ("host", "fused")
# the serving cell's engine: 8 slots of up to 256 tokens, in pages of 16
# (or a dense slab), prefill chunks of 64
ENGINE = EngineConfig(max_len=256, n_slots=8, paged=True, page_size=16,
                      prefill_chunk=64)


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


def adapter_pool(cfg, mode: str, adapter_ranks: Sequence[int],
                 seed: int = 0, dtype=torch.bfloat16, device=None):
    """The mixed-rank pool of adapters (ids 0..N-1) the ``mode``'s plane
    serves, drawn from ``seed``: the expert-FFN targets (the hooks the LoRA
    Server computes) for "disagg", all of the config's targets for
    "coupled". The pool rank is the largest true rank."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    if mode == "disagg":
        cfg = dataclasses.replace(cfg, lora_targets=FFN_TARGETS)
    return init_mixed_rank_pool(cfg, adapter_ranks, seed=seed + 1,
                                dtype=dtype, device=device)


def build_lora(cfg, mode: str, adapter_ranks: Sequence[int], seed: int = 0,
               dtype=torch.bfloat16, device=None, replicas: int = 1) -> Dict:
    """One mixed-rank pool served by one plane; returns the Engine's
    keyword arguments for it: {"server", "pool"} (``build_pool``) for
    "disagg", {"pool"} for "coupled"."""
    if mode == "disagg":
        return build_pool(cfg, adapter_ranks, replicas, seed=seed,
                          dtype=dtype, device=device)
    return {"pool": adapter_pool(cfg, mode, adapter_ranks, seed=seed,
                                 dtype=dtype, device=device)}


def build_pool(cfg, adapter_ranks: Sequence[int], replicas: int = 1,
               seed: int = 0, dtype=torch.bfloat16, device=None,
               partition_slots: bool = False) -> Dict:
    """The disaggregated plane with every adapter resident: ``replicas``
    LoRA-Server replicas of one slot per adapter (with
    ``partition_slots``: each of its share of them, the mesh plane's
    layout), each adapter written into its affinity home at its true rank;
    returns the Engine's keyword arguments {"server", "pool"}. (The front
    door brings adapters in as requests need them instead.)"""
    pool = adapter_pool(cfg, "disagg", adapter_ranks, seed=seed, dtype=dtype,
                        device=device)
    sp = ServerPool.build(cfg, pool, cache_slots=pool.n, n_replicas=replicas,
                          dtype=dtype, device=device,
                          partition_slots=partition_slots)
    every = LoRACache(pool.n, adapter_bytes=0, n_layers=cfg.n_layers,
                      layerwise=False, prefetch=False)
    for aid in range(pool.n):
        every.admit(aid, 0.0)
    sp.sync(every, lambda a: pool_tensors_from_adapter(pool, a),
            pool.rank_of)
    return {"server": sp, "pool": pool}


def serve(engine: Engine, requests, traffic: Traffic) -> Dict:
    """Run ``requests`` through one ``engine`` in two waves; every request
    takes ``traffic.new_tokens`` greedy tokens. Returns tokens per rid and
    the run's counts and host-clock times (each step ends in a device
    sync: its tokens come back to the host). The engine-level loop of the
    step timings; ``serve_system`` serves through the front door."""
    tokens: Dict[int, List[int]] = {rid: [] for rid, _, _ in requests}
    pending = list(requests)
    waiting: List = []
    prefill_s = decode_s = 0.0
    steps = 0
    bucket_rows = []

    def admit():
        nonlocal prefill_s
        t0 = wall_time()
        while waiting and engine.free_slots():
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
            "prefill_chunks": engine.prefill_chunks,
            "decode_s": decode_s,
            "decode_ms_per_step": 1e3 * decode_s / max(steps, 1),
            "tokens_per_s": n_tok / decode_s if decode_s else 0.0}


def serve_config(traffic: Traffic, mode: str = "disagg", paged: bool = True,
                 transport: str = "host", replicas: int = 1, **kw):
    """The front door's config of the serving cell: ``ENGINE``'s slots,
    lengths, pages and chunks, one cache slot per adapter, one round a
    virtual second (``kw`` overrides any field)."""
    return ServeConfig(**{**dict(
        backend="cluster", disaggregated=mode == "disagg", paged=paged,
        transport=transport, server_replicas=replicas, n_instances=1,
        max_batch=ENGINE.n_slots, max_len=ENGINE.max_len,
        page_size=ENGINE.page_size, prefill_chunk=ENGINE.prefill_chunk,
        adapter_cache_slots=len(traffic.adapter_ranks), step_time=1.0),
        **kw})


def submit_traffic(system, requests, traffic: Traffic):
    """Submit ``requests`` through the front door with their prompts, in
    order (the system numbers them): the first wave arrives now, the rest
    ``traffic.second_wave_after`` rounds later (the waves of ``serve``).
    Returns the handles."""
    later = system.now + traffic.second_wave_after * system.cfg.step_time
    return [system.submit(prompt, aid, max_new_tokens=traffic.new_tokens,
                          arrival=system.now if i < traffic.first_wave
                          else later)
            for i, (_, prompt, aid) in enumerate(requests)]


def serve_system(system, requests, traffic: Traffic,
                 stream: Optional[int] = None) -> Dict:
    """Serve ``requests`` through the front door (``submit_traffic``),
    streaming the tokens of request number ``stream`` through its handle's
    iterator when given, then draining. Returns tokens per request rid,
    the rounds and their mean host-clock time (each round ends in a device
    sync; the clock spans the streaming and the drain, prefill included),
    the streamed tokens, the ``Summary`` (TTFT and TPOT in rounds) and the
    system's stats."""
    handles = submit_traffic(system, requests, traffic)
    rnd0 = system.backend.cluster.rnd
    t0 = wall_time()
    streamed = list(handles[stream]) if stream is not None else None
    system.drain()
    wall = wall_time() - t0
    rounds = system.backend.cluster.rnd - rnd0
    rejected = [h.error for h in handles if h.error]
    if rejected:
        raise RuntimeError(f"requests rejected: {rejected}")
    n_tok = sum(len(h.tokens) for h in handles)
    return {"tokens": {rid: list(h.tokens)
                       for (rid, _, _), h in zip(requests, handles)},
            "streamed": streamed, "rounds": rounds,
            "wall_ms_per_round": 1e3 * wall / max(rounds, 1),
            "generated_tokens": n_tok,
            "tokens_per_s": n_tok / wall if wall else 0.0,
            "summary": system.summary(), "kv_stats": system.kv_stats(),
            "cache_stats": system.cache_stats(),
            "transport_stats": system.transport_stats()}


def model(arch: str, *, layers: Optional[int] = None, reduced: bool = False,
          seed: int = 0, device=None):
    """(cfg, params): the config (``reduced``, or cut to ``layers``) and its
    weights drawn on ``device`` from ``seed``."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dev = resolve_device(device)
    return cfg, init_params(cfg, seed=seed, dtype=resolve_dtype(cfg.dtype),
                            device=dev)


def build(arch: str, *, layers: Optional[int] = None, reduced: bool = False,
          seed: int = 0, device=None, traffic: Traffic = Traffic(),
          mode: str = "disagg", paged: bool = True, replicas: int = 1):
    """(cfg, params, lora, engine config) for one engine-level run, where
    ``lora`` is the Engine's keyword arguments of the ``mode``'s plane
    (``build_lora``; disagg: ``replicas`` server replicas) and the engine
    config is ``ENGINE`` with the ``paged`` layout."""
    cfg, params = model(arch, layers=layers, reduced=reduced, seed=seed,
                        device=device)
    lora = build_lora(cfg, mode, traffic.adapter_ranks, seed=seed,
                      dtype=resolve_dtype(cfg.dtype), device=device,
                      replicas=replicas)
    return cfg, params, lora, dataclasses.replace(ENGINE, paged=paged)


def compare_planes(cfg, n_adapters: int = 8, rate: float = 25.0,
                   duration: float = 120.0, gpus_per_instance: int = 8,
                   seed: int = 0, hw: Hardware = H100) -> Dict[str, Dict]:
    """The S-LoRA vs InfiniLoRA comparison on the analytic plane (Fig. 11's
    presets: S-LoRA on 4 instances, InfiniLoRA on 3 plus a LoRA Server of
    ``gpus_per_instance`` GPUs), one Poisson workload of ``rate`` requests a
    second over ``n_adapters`` zipf adapters for ``duration`` virtual
    seconds through ``backend="sim"``, priced on ``hw`` (the presets' cache
    slots too): each plane's ``Summary`` fields."""
    reqs = workload.generate(n_adapters, rate=rate, duration=duration,
                             seed=seed)
    planes = {
        "s-lora": presets.slora_config(cfg, 4, gpus_per_instance,
                                       n_adapters, duration, hw=hw),
        "infinilora": presets.infinilora_config(
            cfg, 3, gpus_per_instance, gpus_per_instance, n_adapters,
            duration, hw=hw)}
    out = {}
    for name, sim in planes.items():
        system = build_system(ServeConfig.from_sim(sim), cfg)
        system.submit_workload(reqs)
        system.drain()
        out[name] = dataclasses.asdict(system.summary(duration=duration))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-235b-a22b",
                    choices=list_archs(assigned_only=False),
                    help="any registered config; disagg needs a MoE arch")
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
    ap.add_argument("--cluster", action="store_true",
                    help="S-LoRA vs InfiniLoRA on the analytic plane "
                         "(full config, nominal H100; no model runs)")
    ap.add_argument("--adapters", type=int, default=8,
                    help="--cluster: adapters of the workload")
    ap.add_argument("--rate", type=float, default=25.0,
                    help="--cluster: requests a virtual second")
    ap.add_argument("--duration", type=float, default=120.0,
                    help="--cluster: virtual seconds of arrivals")
    ap.add_argument("--gpus-per-instance", type=int, default=8,
                    help="--cluster: GPUs of an instance and of the server")
    args = ap.parse_args(argv)
    if args.cluster:
        res = compare_planes(get_config(args.arch), args.adapters, args.rate,
                             args.duration, args.gpus_per_instance,
                             args.seed)
        for name, s in res.items():
            print(f"{name:12s} p95_ttft={s['p95_ttft']:8.3f}s "
                  f"tpot={s['mean_tpot']:.4f}s "
                  f"thr={s['throughput_rps']:7.2f}r/s "
                  f"attain={s['slo_attainment']:.2%} (analytic, H100 "
                  f"nominal)")
        print(json.dumps(res))
        return 0
    if not get_config(args.arch).is_moe and args.mode == "disagg":
        raise SystemExit("disaggregated hooks target MoE archs; use coupled")
    traffic = dataclasses.replace(Traffic(), n_requests=args.requests)
    if args.reduced:
        traffic = dataclasses.replace(traffic, prompt_len=(6, 20),
                                      new_tokens=6, second_wave_after=2)
    cfg, params = model(args.arch, layers=args.layers, reduced=args.reduced,
                        seed=args.seed, device=args.device)
    pool = adapter_pool(cfg, args.mode, traffic.adapter_ranks,
                        seed=args.seed, dtype=resolve_dtype(cfg.dtype),
                        device=args.device)
    system = build_system(serve_config(
        traffic, args.mode, paged=not args.dense, transport=args.transport,
        replicas=args.replicas), cfg, params=params, pool=pool)
    try:
        res = serve_system(system, make_requests(cfg, traffic, args.seed),
                           traffic)
    finally:
        system.close()
    print(json.dumps({"mode": args.mode, "paged": not args.dense,
                      **{k: res[k] for k in ("rounds", "wall_ms_per_round",
                                             "generated_tokens",
                                             "tokens_per_s")},
                      "summary": dataclasses.asdict(res["summary"])}))
    print(json.dumps({"kv_stats": res["kv_stats"],
                      "cache_stats": res["cache_stats"],
                      "transport": res["transport_stats"]}))
    print("generated:", res["tokens"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
