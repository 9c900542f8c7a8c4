"""Train per-tenant LoRA adapters against a frozen base model, the
counterpart of ``examples/train_lora.py``: the substrate that makes what
the serving system hosts. Two tenants with different synthetic skills,
each adapter trained through ``training.train_step.make_lora_train_step``
(AdamW on the adapter, the base frozen), then a cross-tenant evaluation:
each adapter helps its own tenant.

    PYTHONPATH=src python -m repro_torch.examples.train_lora
    PYTHONPATH=src python -m repro_torch.examples.train_lora --device cpu
    PYTHONPATH=src python -m repro_torch.examples.train_lora --steps 3

Prints "tenant T step S loss X" lines, the evaluation table and
``adapter 1 improves tenant 1: True``; exits 1 when it does not.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.adapter import init_adapter_pool
from repro_torch.models import transformer
from repro_torch.models.model import init_params, resolve_device
from repro_torch.training import data as data_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train_step import lm_loss, make_lora_train_step

ARCH = "smollm-360m"


def _batch(dcfg, step, device):
    toks, labels = data_mod.batch_at(dcfg, step)
    return {"tokens": torch.as_tensor(toks, device=device),
            "labels": torch.as_tensor(labels, device=device)}


@torch.no_grad()
def eval_loss(cfg, params, adapter, scale, dcfg, device, step=999):
    b = _batch(dcfg, step, device)
    ctx = None
    if adapter is not None:
        ctx = {"adapters": adapter, "scale": scale,
               "ids": torch.zeros((b["tokens"].shape[0],), dtype=torch.int32,
                                  device=device)}
    logits, _ = transformer.forward(params, cfg, b["tokens"], kind="prefill",
                                    lora_ctx=ctx)
    return float(lm_loss(logits, b["labels"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(ARCH).reduced()
    params = init_params(cfg, seed=0, dtype=torch.float32, device=device)
    opt_cfg = opt_mod.AdamWConfig(lr=5e-3, warmup_steps=2,
                                  total_steps=max(args.steps, 3),
                                  weight_decay=0.0)
    print(f"model: {cfg.name} ({cfg.n_layers} layers, d={cfg.d_model}), "
          f"f32, on {device}; {args.steps} steps a tenant")

    adapters = {}
    for tenant in (1, 2):
        dcfg = data_mod.DataConfig(cfg.vocab_size, 32, 8, tenant_id=tenant)
        pool = init_adapter_pool(cfg, 1, seed=tenant, rank=8,
                                 dtype=torch.float32, device=device)
        step = make_lora_train_step(cfg, params, pool.scale, opt_cfg)
        adapter, opt_state = pool.tensors, opt_mod.init(pool.tensors)
        for s in range(args.steps):
            loss, adapter, opt_state, _ = step(adapter, opt_state, None,
                                               _batch(dcfg, s, device))
            if s % 10 == 0 or s == args.steps - 1:
                print(f"tenant {tenant} step {s:3d} loss {float(loss):.4f}")
        adapters[tenant] = (adapter, pool.scale)

    print("\ncross-tenant evaluation (rows: adapter, cols: tenant data):")
    d1 = data_mod.DataConfig(cfg.vocab_size, 32, 8, tenant_id=1)
    d2 = data_mod.DataConfig(cfg.vocab_size, 32, 8, tenant_id=2)
    base = [eval_loss(cfg, params, None, 1.0, d, device) for d in (d1, d2)]
    print(f"  base    : {base[0]:.4f}  {base[1]:.4f}")
    own = None
    for t in (1, 2):
        a, sc = adapters[t]
        l1 = eval_loss(cfg, params, a, sc, d1, device)
        l2 = eval_loss(cfg, params, a, sc, d2, device)
        own = l1 if t == 1 else own
        print(f"  adapter{t}: {l1:.4f}  {l2:.4f}")
    better = own < base[0]
    print(f"adapter 1 improves tenant 1: {better}")
    return 0 if better else 1


if __name__ == "__main__":
    raise SystemExit(main())
