"""The per-rank side of ``tests/test_torch_spmd_layout.py``: what each
process of a 4-rank gloo world runs over the grids (2, 2), (1, 4) and
(4, 1). No JAX here: the ranks import only torch, numpy and the port.

For each config (``inp["configs"]``: a name -> the config and its global
parameters as numpy arrays) and grid: ``jit_train_step``,
``jit_prefill_step`` and ``jit_serve_step`` on this rank's shards of the
reference's layout (``torch_spmd_cases``'s step cases, their outputs
gathered whole to rank 0), the train step under batch-only rules too
(``inp["batch_only"]``'s configs), and every rank's parameter, moment and
cache bytes in that layout beside ``analysis.memory_est``'s.
"""
from __future__ import annotations

import dataclasses
import traceback

import torch

import torch_spmd_cases as base
from repro_torch.analysis.memory_est import analytic_device_bytes
from repro_torch.distributed import steps as tsteps
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.cache import init_cache
from repro_torch.training import optimizer as topt
from repro_torch.training.tree import flatten_with_keys, tree_map

GRIDS = base.GRIDS


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in flatten_with_keys(tree).values()
               if torch.is_tensor(t))


def bytes_case(mesh, inp, which):
    """{kind: (this rank's allocated bytes, memory_est's)} for each step
    kind: the parameters cut to this rank's
    shards as the step takes them and AdamW's moments of them (train), in
    f32 as the steps run here, and the cache's shards (decode) at its
    default (bf16) KV dtype."""
    cfg = dataclasses.replace(inp[which + "_cfg"], dtype="float32")
    params = base._t(inp[which + "_model"])
    out = {}
    for kind, shape in (("train", inp["train_shape"]),
                        ("prefill", inp["prefill_shape"]),
                        ("decode", inp["serve_shape"])):
        rules = tsteps.rules_for(mesh, kind, cfg)
        place = tsteps.step_placements(cfg, rules)
        p_l = tree_map(lambda t: t.clone(), tsteps.local_params(params,
                                                                place))
        got = {"params": _nbytes(p_l)}
        if kind == "train":
            opt = topt.init(p_l)
            got["opt_state"] = _nbytes({"m": opt["m"], "v": opt["v"]})
        if kind == "decode":
            _, cpl = tsteps.cache_specs(cfg, shape, rules)
            cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                               device="cpu")
            got["cache"] = _nbytes({k: cpl[k].local(v).clone()
                                    for k, v in cache.items()
                                    if torch.is_tensor(v)})
        an = analytic_device_bytes(cfg, shape, rules, kind)
        out[kind] = (got, {k: an[k] for k in got})
    return out


def dropless(cfg):
    """``cfg`` with a capacity factor of E / K where it is a MoE: no pair
    overflows a rank's capacity, whatever its token count, so the sharded
    step drops what the local one does (nothing)."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.top_k) if cfg.is_moe else cfg


def train_batch_only_case(mesh, inp, which):
    """``make_train_step`` under the train rules with "seq" None (the
    batch-only rules a frontend takes): the tokens are replicated over
    "model", which still shards the weights at rest, so a weight's
    gathers there must not sum its gradient. The loss and the updated
    parameters, gathered whole; a MoE ``dropless`` (a rank's 16 tokens
    would overflow other pairs than the local step's 32)."""
    cfg, params = dropless(inp[which + "_cfg"]), base._t(inp[which + "_model"])
    batch = {k: base._t(v) for k, v in inp["step_batch"].items()}
    B, S = batch["tokens"].shape
    rules = tsteps.rules_for(mesh, "train", cfg, overrides={"seq": None})
    step = tsteps.make_train_step(cfg, rules, topt.AdamWConfig(**inp["opt"]))
    place = tsteps.step_placements(cfg, rules)
    p_l = tree_map(lambda t: t.clone(), tsteps.local_params(params, place))
    bpl = tsteps.Placement(mesh, rules.spec(("batch", "seq"), (B, S)), (B, S))
    loss, p_new, _ = step(p_l, topt.init(p_l),
                          {k: bpl.local(v).clone() for k, v in batch.items()})
    whole = tsteps.whole_params(p_new, place)
    return {"loss": float(loss),
            "params": {k: base._np(v)
                       for k, v in flatten_with_keys(whole).items()}}


CASES = {"train": base.train_step_case, "prefill": base.prefill_step_case,
         "serve": base.serve_step_case, "bytes": bytes_case,
         "train_batch_only": train_batch_only_case}


def run(rank, world, inp):
    """{(config, case, grid): result} of every case on every grid: rank
    0's, and every rank's byte counts. A failing case is reported as its
    traceback, so the other cases still run."""
    out = {}
    for grid in GRIDS:
        mesh = make_debug_mesh(*grid)
        for which in inp["configs"]:
            for case, fn in CASES.items():
                if case == "train_batch_only" and \
                        which not in inp["batch_only"]:
                    continue
                try:
                    res = fn(mesh, inp, which)
                except Exception:   # reported to the parent as that case's
                    res = {"error": traceback.format_exc()}
                if rank == 0 or case == "bytes":
                    out[(which, case, grid)] = res
    return out
