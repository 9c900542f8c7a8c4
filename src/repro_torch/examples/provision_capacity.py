"""Capacity planner, the counterpart of ``examples/provision_capacity.py``:
walk a workload through §4.2 — Zipf popularity in, minimum cache size and
server GPU count out; then the elastic re-provisioner reacting to a
popularity shift (appendix A.1.1). It runs no model and needs no device:
the cost model prices a nominal H100 (``core.cost_model.H100``).

    PYTHONPATH=src python -m repro_torch.examples.provision_capacity
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core import provisioning as P
from repro_torch.training.fault_tolerance import reprovision_on_workload_shift


def main(argv=None) -> int:
    cfg = get_config("qwen3-30b-a3b")
    print(f"model: {cfg.name}; one adapter = "
          f"{cfg.lora_adapter_bytes() / 2**30:.2f} GiB")

    print("\ncache size vs workload skew (512 adapters, LB=1024):")
    for s in (0.8, 1.2, 1.5):
        probs = P.zipf_probs(512, s)
        m = P.min_cache_size(probs, 1024, alpha=0.95)
        print(f"  zipf s={s}: M* = {m:4d} adapters "
              f"(IAR={P.iar(probs, 1024, m):.3f})")

    print("\nfull provisioning (paper §6 setup, nominal H100 GPUs):")
    for n_inst in (2, 4, 6):
        rep = P.provision(cfg, 512, n_instances=n_inst, b=128, p=8)
        print(f"  {n_inst} instances: M*={rep.M_star:4d} "
              f"cache_gpus={rep.gpus_for_cache} tpot_gpus={rep.gpus_for_tpot}"
              f" -> {rep.gpus} GPUs ({rep.placement.describe()})")

    print("\nelastic re-provisioning on a workload shift (A.1.1):")
    current = P.provision(cfg, 512, 4, 128, 8).gpus

    def provision_fn(observed):
        return P.provision(cfg, len(observed), 4, 128, 8, probs=observed)

    flat = P.zipf_probs(1024, 1.2)  # the pool doubles: more cache
    new, rep = reprovision_on_workload_shift(provision_fn, flat, current)
    print(f"  pool 512->1024 adapters: {current} -> {new} GPUs "
          f"(M*={rep.M_star})")
    hot = P.zipf_probs(256, 1.5)    # high locality: shrink
    new2, rep2 = reprovision_on_workload_shift(provision_fn, hot, current)
    print(f"  hot pool of 256:        {current} -> {new2} GPUs "
          f"(M*={rep2.M_star})")
    print(f"grows for the larger pool: {new >= current}; shrinks for the "
          f"hot one: {new2 <= current}")
    return 0 if new >= current >= new2 else 1


if __name__ == "__main__":
    raise SystemExit(main())
