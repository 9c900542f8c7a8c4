"""Dry run of the production meshes on meta tensors, the counterpart of
``repro.launch.dryrun``: one process stands as one rank of the mesh and
traces each (arch x shape) cell's SPMD step, counting its work.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-moe-235b-a22b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh multi]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --disagg

The process joins a ``fake`` process group of the mesh's size (256 ranks
for "single", 512 for "multi", 8 for the tests' "debug" (2, 4) mesh; its
collectives move nothing) as rank 0, builds ``launch.mesh.make_production_mesh`` over it, and calls
``jit_train_step`` / ``jit_prefill_step`` / ``jit_serve_step`` on this
rank's shards (``steps.local_params`` of the abstract tree, as meta
tensors) under ``analysis.counter.count``: the kernels take their plain
twins' shape arithmetic (``kernels.ops``), nothing computes, and a cell
traces in seconds. A record a cell, ``status`` OK / SKIP (``applicable``)
/ FAIL, with ``memory`` (``analysis.memory_est``: the analytic bytes and
``fits_80g``) and ``roofline`` (``analysis.roofline`` of the counted step,
the kernels in their shape form).

Records go to experiments/dryrun_torch/<cell>.json (or ``--out``); a
cached record is kept unless ``--force``. This is the proof that the
port's distribution config is coherent at full size: a layout that does
not divide, a shape error or a host read on the step's path fails here.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import traceback

import torch
import torch.distributed as dist

from repro_torch.analysis import roofline as RL
from repro_torch.analysis.counter import count
from repro_torch.analysis.memory_est import analytic_device_bytes
from repro_torch.configs import ASSIGNED, SHAPES, applicable, get_config, \
    get_shape
from repro_torch.distributed import steps as steps_mod
from repro_torch.launch.mesh import make_debug_mesh, make_process_mesh, \
    make_production_mesh
from repro_torch.obs.clock import wall_time

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")
MESH_SIZE = {"single": 256, "multi": 512, "debug": 8}


def mesh_of(mesh_name: str):
    """The mesh ``mesh_name`` names over the current world: the production
    (16, 16) or (2, 16, 16), or the (2, 4) debug mesh of the tests."""
    if mesh_name == "debug":
        return make_debug_mesh(2, 4)
    return make_production_mesh(multi_pod=(mesh_name == "multi"))


def cell_id(arch: str, shape: str, mesh: str, variant: str = "base") -> str:
    return f"{arch}__{shape}__{mesh}" + ("" if variant == "base"
                                         else f"__{variant}")


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """This process as rank ``rank`` of a ``fake`` process group of
    ``world`` ranks (no communication: each collective returns its
    output uninitialised), destroyed on exit."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _contiguous(tree):
    """Each leaf as its own contiguous tensor (a shard of a meta tensor is
    a strided view; the steps update some leaves in place)."""
    if isinstance(tree, dict):
        return {k: _contiguous(v) for k, v in tree.items()}
    return tree.contiguous() if isinstance(tree, torch.Tensor) else tree


def _local_batch(cfg, shape, rules, batch):
    specs = steps_mod.batch_specs(cfg, shape, rules)
    return {k: specs[k][1].local(v).contiguous() for k, v in batch.items()}


def trace_cell(cfg, shape, mesh, kv_quant: bool = False):
    """(the counted step's summary in the shape form, rules, the output's
    shape): one step of ``shape`` on this rank's meta shards."""
    kind = shape.kind
    if kind == "train":
        step, (p, opt, batch), rules = steps_mod.jit_train_step(
            cfg, shape, mesh)
    elif kind == "prefill":
        step, (p, batch), rules = steps_mod.jit_prefill_step(cfg, shape, mesh)
    else:
        step, (p, cache, batch), rules = steps_mod.jit_serve_step(
            cfg, shape, mesh, kv_quant=kv_quant)
    lb = _local_batch(cfg, shape, rules, batch)
    place = steps_mod.step_placements(cfg, rules)
    params = _contiguous(steps_mod.local_params(p, place))
    if kind == "train":
        args = (params, {"m": _contiguous(steps_mod.local_params(opt["m"],
                                                                 place)),
                         "v": _contiguous(steps_mod.local_params(opt["v"],
                                                                 place)),
                         "step": opt["step"]}, lb)
    elif kind == "prefill":
        args = (params, lb)
    else:
        _, c_place = steps_mod.cache_specs(cfg, shape, rules, kv_quant)
        args = (params, {k: (c_place[k].local(v).contiguous()
                             if isinstance(v, torch.Tensor) else v)
                         for k, v in cache.items()}, lb)
    with count() as c:
        out = step(*args)
    if isinstance(out, tuple):      # (loss, ...) or (logits, cache)
        out = out[0]
    return c.summary("shape"), rules, tuple(out.shape)


def compile_cell(arch: str, shape_name: str, mesh_name: str,
                 kv_quant: bool = False, reduced: bool = False):
    """One cell's record; the caller has joined a fake world of the mesh's
    size. ``reduced``: the config's ``reduced()`` at the shape's sizes."""
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    shape = get_shape(shape_name)
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"status": "SKIP", "reason": reason}
    mesh = mesh_of(mesh_name)
    chips = mesh.devices.size
    t0 = wall_time()
    counted, rules, out_shape = trace_cell(cfg, shape, mesh, kv_quant)
    t_trace = wall_time() - t0
    analytic = analytic_device_bytes(cfg, shape, rules, shape.kind,
                                     kv_quant=kv_quant)
    peak = analytic["total_as_run"]
    rl = RL.analyze(arch, shape_name, mesh_name, chips, counted, peak, cfg,
                    shape)
    return {
        "status": "OK", "rank": mesh.rank,
        "trace_s": round(t_trace, 2), "output_shape": list(out_shape),
        "memory": {"peak_per_device": peak,
                   "fits_80g": analytic["fits_80g"], "analytic": analytic},
        "counted": counted,
        "roofline": rl.to_dict(),
    }


def compile_disagg(arch: str, mesh_name: str = "single", x: int = 4,
                   y: int = 2, n_slots: int = 64, batch_rows: int = 1024,
                   reduced: bool = False):
    """The disaggregated split, the reference's: the LoRA-free instance's
    decode step on the mesh's leading (data, model) positions (this
    process one rank of a fake world of that size), and the LoRA Server's
    up and down hooks on the trailing x*y positions (the EP x PP server
    over meta devices); the rows a layer moves between them. Joins and
    leaves its own fake world."""
    from repro_torch.core.lora_server import LoRAServer, ServerConfig, \
        make_server_mesh

    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    shape = get_shape("decode_32k")
    m = x * y
    model = 4 if mesh_name == "debug" else 16
    data = (MESH_SIZE[mesh_name] - m) // model
    rec = {"instance_mesh": f"{data}x{model}", "server_mesh": f"{x}x{y}"}
    # 1) the base (LoRA-free) decode step on the instance's positions
    bshape = dataclasses.replace(shape, global_batch=max(data * 4, 32))
    with fake_world(data * model):
        inst = make_process_mesh((data, model), ("data", "model"))
        counted, _, _ = trace_cell(cfg, bshape, inst)
    rec["instance"] = {"flops_per_device": counted["flops"],
                       "bytes_per_device": counted["hbm_bytes"],
                       "coll_bytes": counted["coll_bytes"],
                       "global_batch": bshape.global_batch}
    # 2) the server's hooks on its (ep, pp) positions, one controller
    server = LoRAServer(cfg, ServerConfig(m=m, x=x, y=y,
                                          cache_slots=n_slots,
                                          rank=cfg.lora_rank),
                        mesh=make_server_mesh(x, y, devices=["meta"]))
    R, E = batch_rows, max(cfg.n_experts, 1)
    ids = torch.empty((R,), dtype=torch.int32, device="meta")
    eids = torch.empty((R,), dtype=torch.int32, device="meta")
    for hook, din in (("up", cfg.d_model), ("down", cfg.d_ff)):
        rows = torch.empty((R, din), dtype=torch.bfloat16, device="meta")
        with count() as c:
            server.compute(hook, 0, rows, ids, eids)
        s = c.summary("shape")
        rec[f"server_{hook}"] = {
            "flops_per_device": s["flops"] / x,
            "bytes_per_device": s["hbm_bytes"] / x,
            "coll_bytes": s["coll_bytes"], "positions": x,
            "arg_bytes": server.cache_bytes() // m,
            "experts": E}
    # transfer volume (the rows a layer moves there and back), per §4.1
    rec["transfer_bytes_per_layer"] = int(R * (cfg.d_model + cfg.d_ff) * 2)
    rec["status"] = "OK"
    return rec


def _write(path: pathlib.Path, rec) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "debug"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--disagg", action="store_true")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="each config's reduced() (a CPU check)")
    ap.add_argument("--out", default=None,
                    help="records directory (default experiments/"
                         "dryrun_torch)")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out) if args.out else OUT_DIR

    if args.disagg:
        arch = args.arch or "qwen3-moe-235b-a22b"
        cid = cell_id(arch, "decode_32k", args.mesh, "disagg")
        try:
            x, y = (2, 1) if args.mesh == "debug" else (4, 2)
            rec = compile_disagg(arch, args.mesh, x, y,
                                 reduced=args.reduced)
        except Exception as e:  # noqa: BLE001 — record and report
            rec = {"status": "FAIL", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        _write(out_dir / f"{cid}.json", rec)
        print(cid, rec["status"], flush=True)
        return 0 if rec["status"] == "OK" else 1

    archs = [args.arch] if args.arch else sorted(ASSIGNED)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.both_meshes else [args.mesh]
    failures = []
    for mesh_name in meshes:
        with fake_world(MESH_SIZE[mesh_name]):
            for arch in archs:
                for shape in shapes:
                    cid = cell_id(arch, shape, mesh_name)
                    path = out_dir / f"{cid}.json"
                    if path.exists() and not args.force:
                        rec = json.loads(path.read_text())
                        print(f"{cid}: cached {rec['status']}")
                        continue
                    try:
                        rec = compile_cell(arch, shape, mesh_name,
                                           kv_quant=args.kv_quant,
                                           reduced=args.reduced)
                    except Exception as e:  # noqa: BLE001 — record, go on
                        rec = {"status": "FAIL",
                               "error": f"{type(e).__name__}: {e}",
                               "trace": traceback.format_exc()[-2000:]}
                        failures.append(cid)
                    _write(path, rec)
                    extra = ""
                    if rec["status"] == "OK":
                        r, mem = rec["roofline"], rec["memory"]
                        extra = (f" peak={mem['peak_per_device'] / 2**30:.2f}"
                                 f"GiB fits_80g={mem['fits_80g']}"
                                 f" bottleneck={r['bottleneck']}"
                                 f" frac={r['roofline_fraction']:.3f}"
                                 f" trace={rec['trace_s']}s")
                    print(f"{cid}: {rec['status']}{extra}", flush=True)
    if failures:
        print("FAILURES:", failures, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
