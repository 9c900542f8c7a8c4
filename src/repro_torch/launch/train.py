"""Training driver, the counterpart of ``repro.launch.train``: base-model
training (every parameter) or a per-tenant LoRA fine-tune, with the
reference's flags and printed lines. Runs on the card unless
``--device cpu``; checkpoint / restart with exact resume in the
full-parameter mode (deterministic data: kill it and relaunch). A run
resumes from any step already in ``--ckpt``, so a new run takes a fresh
directory.

  CK=$(mktemp -d "${TMPDIR:-/tmp}/ck-XXXXXX")
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --steps 50 --batch 8 --seq 64 --ckpt "$CK" --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduced --lora --tenant 3 --steps 30 --device cpu
  # on the card: full width, the depth cut to fit it, bf16 base weights
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3-moe-235b-a22b --layers 4 --dtype bfloat16 --lora \\
      --batch 4 --seq 1024 --steps 20

Base weights come from seed 0, the adapter (rank 8, f32) from seed 1
(``build_params`` / ``build_adapter``)."""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.adapter import init_adapter_pool
from repro_torch.models.model import init_params, resolve_device
from repro_torch.obs.clock import wall_time
from repro_torch.training import checkpoint as ckpt_mod
from repro_torch.training import data as data_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train_step import make_lora_train_step, \
    make_train_step

LORA_RANK = 8


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    choices=list_archs(assigned_only=False))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="model depth (cut, where the full depth does not "
                         "fit one card)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lora", action="store_true")
    ap.add_argument("--tenant", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="the base weights' dtype")
    return ap


def build_params(cfg, args):
    """The base weights (seed 0)."""
    return init_params(cfg, seed=0, dtype=args.dtype, device=args.device)


def build_adapter(cfg, args):
    """(adapter tree {target: {"A": (L, 1, ...), "B": ...}} f32, scale):
    one rank-8 adapter on the config's targets (seed 1)."""
    pool = init_adapter_pool(cfg, 1, seed=1, rank=LORA_RANK,
                             dtype=torch.float32, device=args.device)
    return pool.tensors, pool.scale


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(argv=None) -> dict:
    """Train as ``main`` does and return the run's record: mode, config,
    the first step, each step's loss and host seconds (each ends in the
    loss's read-back), and the final trees (params, adapter and its
    scale, optimizer state)."""
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = resolve_device(args.device)
    params = build_params(cfg, args)
    opt_cfg = opt_mod.AdamWConfig(lr=args.lr, warmup_steps=10,
                                  total_steps=args.steps)
    dcfg = data_mod.DataConfig(cfg.vocab_size, args.seq, args.batch,
                               tenant_id=args.tenant)
    rec = {"mode": "lora" if args.lora else "full", "cfg": cfg,
           "losses": {}, "step_s": {}, "params": params}

    def batch(s):
        toks, labels = data_mod.batch_at(dcfg, s)
        return {"tokens": torch.as_tensor(toks, device=dev),
                "labels": torch.as_tensor(labels, device=dev)}

    if args.lora:
        adapter, scale = build_adapter(cfg, args)
        opt_state = opt_mod.init(adapter)
        step_fn = make_lora_train_step(cfg, params, scale, opt_cfg)
        err = None
        rec.update(start=0, scale=scale)
        for s in range(args.steps):
            t0 = wall_time()
            loss, adapter, opt_state, err = step_fn(adapter, opt_state, err,
                                                    batch(s))
            rec["losses"][s] = float(loss)
            rec["step_s"][s] = wall_time() - t0
            if s % args.log_every == 0 or s == args.steps - 1:
                print(f"lora step {s:5d} loss {float(loss):.4f}", flush=True)
        rec.update(adapter=adapter, opt_state=opt_state)
        return rec

    opt_state = opt_mod.init(params)
    step_fn = make_train_step(cfg, opt_cfg)
    start = 0
    mgr = None
    if args.ckpt:
        mgr = ckpt_mod.CheckpointManager(args.ckpt, every=args.ckpt_every)
        last = ckpt_mod.latest_step(args.ckpt)
        if last is not None:
            state = ckpt_mod.restore(args.ckpt, last,
                                     {"p": params, "o": opt_state})
            params, opt_state = state["p"], state["o"]
            start = last
            print(f"resumed from step {start}", flush=True)
    rec["start"] = start
    t0 = wall_time()
    for s in range(start, args.steps):
        ts = wall_time()
        loss, params, opt_state = step_fn(params, opt_state, batch(s))
        rec["losses"][s] = float(loss)
        rec["step_s"][s] = wall_time() - ts
        if mgr:
            mgr.maybe_save(s + 1, {"p": params, "o": opt_state})
        if s % args.log_every == 0 or s == args.steps - 1:
            dt = (wall_time() - t0) / max(s - start + 1, 1)
            print(f"step {s:5d} loss {float(loss):.4f} ({dt*1e3:.0f} ms/step)",
                  flush=True)
    if mgr:
        mgr.maybe_save(args.steps, {"p": params, "o": opt_state}, force=True)
        mgr.finalize()
    _sync(dev)
    rec.update(params=params, opt_state=opt_state)
    return rec


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
