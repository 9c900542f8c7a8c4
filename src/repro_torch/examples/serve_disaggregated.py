"""End-to-end driver of the port (the paper's system) through the one
serving front door, the counterpart of ``examples/serve_disaggregated.py``:
serve a MoE model with continuous batching on the cluster plane in both
architectures —

  ServeSystem.submit -> token-level Scheduler admission -> slot engines
  (requests join the running batch mid-decode) -> a 2-replica pool of LoRA
  Servers -> per-layer hook round trips -> the coupled plane's tokens,

then a cancellation under churn, and the cluster-scale view: SLO-driven
provisioning (Algorithm 1) choosing the server size, and S-LoRA against
InfiniLoRA under load on the analytic plane (``backend="sim"``; modelled
times on a nominal H100, not measured).

    PYTHONPATH=src python -m repro_torch.examples.serve_disaggregated
    PYTHONPATH=src python -m repro_torch.examples.serve_disaggregated \
        --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_disaggregated \
        --layers 2          # Qwen3-235B-A22B's widths, 2 of its 94 layers

It prints ``tokens identical across architectures: True`` when the two
planes served the same tokens, and exits 1 otherwise.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.baselines import slora as presets
from repro_torch.configs import get_config
from repro_torch.core import provisioning as P
from repro_torch.core.adapter import init_mixed_rank_pool
from repro_torch.models.model import init_params, resolve_device
from repro_torch.serving import workload
from repro_torch.serving.api import ServeConfig, build_system

ARCH = "qwen3-moe-235b-a22b"
REQS = [
    # (adapter, arrival, prompt_len, output_len): rid 2/3 join while 0/1
    # are mid-decode; with only 2 slots an instance, rid 4 waits for an
    # eviction
    (0, 0.0, 5, 7), (2, 0.0, 4, 6), (5, 2.0, 6, 5),
    (1, 3.0, 3, 5), (3, 4.0, 4, 4),
]
RANKS = [2, 4, 8, 4, 2, 8]     # heterogeneous true ranks in a rank-8 pool


def model(device, layers=None):
    """(cfg, params, pool): the reduced config, or the full widths cut to
    ``layers``, in f32 (as the reference's example); adapters on the
    expert FFN of true ranks RANKS."""
    cfg = get_config(ARCH)
    cfg = cfg.reduced() if layers is None else dataclasses.replace(
        cfg, n_layers=layers)
    cfg = dataclasses.replace(cfg, lora_targets=("gate", "up", "down"),
                              lora_rank=8, dtype="float32")
    params = init_params(cfg, seed=0, device=device)
    pool = init_mixed_rank_pool(cfg, RANKS, seed=1,
                                dtype=params["embed"].dtype, device=device)
    return cfg, params, pool


def serve(cfg, params, pool, disaggregated, cancel_rid=None):
    """The five requests through the front door: 2 instances of 2 slots;
    disaggregated, a pool of 2 LoRA-Server replicas."""
    system = build_system(
        ServeConfig(backend="cluster", disaggregated=disaggregated,
                    n_instances=2, max_batch=2, max_len=32,
                    adapter_cache_slots=6, server_replicas=2),
        cfg, params=params, pool=pool)
    handles = [system.submit(adapter_id=a, arrival=t, prompt_len=p,
                             max_new_tokens=o) for a, t, p, o in REQS]
    if cancel_rid is not None:
        h = handles[cancel_rid]
        while h.n_tokens < 2:       # let it reach mid-decode first
            system.step()
        h.cancel()
    system.drain()
    return system, handles


def functional_demo(device, layers=None) -> bool:
    print("=== front door: disaggregated == coupled, per token ===")
    cfg, params, pool = model(device, layers)
    print(f"  {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, f32, on {device}")
    _, hs_c = serve(cfg, params, pool, disaggregated=False)
    _, hs_d = serve(cfg, params, pool, disaggregated=True)
    for h in hs_c:
        print(f"  rid={h.rid} adapter={h.request.adapter_id} "
              f"arrival={h.request.arrival:.0f}: {h.tokens}")
    same = all(c.tokens == d.tokens for c, d in zip(hs_c, hs_d))
    print("  mid-decode admission on both paths; a 2-replica LoRA-Server "
          "pool on the disaggregated one")
    print(f"tokens identical across architectures: {same}")

    print("\n=== cancellation under churn ===")
    system, hs = serve(cfg, params, pool, disaggregated=True, cancel_rid=0)
    st = system.kv_stats()
    print(f"  rid=0 cancelled after {hs[0].n_tokens}/"
          f"{hs[0].request.output_len} tokens [{hs[0].state.name.lower()}]; "
          f"others: {[h.state.name.lower() for h in hs[1:]]}")
    print(f"  slots in use after drain: "
          f"{[s['slots_in_use'] for s in st.values()]}")
    cancelled = hs[0].request.finish < 0 and all(h.done for h in hs)
    return same and cancelled


def provisioning_demo():
    print("\n=== SLO-driven provisioning (Algorithm 1 + Eqs 5-6) ===")
    cfg = get_config("qwen3-30b-a3b")
    rep = P.provision(cfg, n_adapters=512, n_instances=4, b=128, p=8,
                      slo_tpot=0.1, alpha=0.95)
    print(f"min cache M* = {rep.M_star} adapters "
          f"({rep.cache_bytes / 2**30:.1f} GiB, IAR={rep.iar:.3f})")
    print(f"server GPUs: cache needs {rep.gpus_for_cache}, TPOT needs "
          f"{rep.gpus_for_tpot} -> provision {rep.gpus} "
          f"({rep.placement.describe()})")
    return rep


def cluster_demo(rep):
    print("\n=== S-LoRA vs InfiniLoRA under load (analytic plane, H100 "
          "nominal; modelled, not measured) ===")
    cfg = get_config("qwen3-30b-a3b")
    duration, n_ad = 80.0, 512
    serve_cfgs = {
        "s-lora": ServeConfig.from_sim(
            presets.slora_config(cfg, 4, 8, n_ad, duration)),
        "infinilora": ServeConfig.from_sim(
            presets.infinilora_config(cfg, 3, 8, max(rep.gpus, 8), n_ad,
                                      duration)),
    }
    for rate in (15, 30, 45):
        reqs = workload.generate(n_ad, rate=rate, duration=duration, seed=0)
        row = [f"rate={rate:3d}"]
        for name, scfg in serve_cfgs.items():
            system = build_system(scfg, cfg)
            system.submit_workload(reqs)
            system.drain()
            s = system.summary(duration=duration)
            row.append(f"{name}: p95ttft={s.p95_ttft:7.3f}s "
                       f"tpot={s.mean_tpot:.3f}s "
                       f"attain={s.slo_attainment:.0%}")
        print("  ".join(row))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="the full widths cut to this depth (default: the "
                         "reduced config)")
    args = ap.parse_args(argv)
    ok = functional_demo(resolve_device(args.device), args.layers)
    rep = provisioning_demo()
    cluster_demo(rep)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
