"""Sharding rule-sets per step kind and the serving plane's expert
parallelism, the serving part of ``repro.distributed.steps``.

Rule-sets (the reference's):
  train/prefill, attention families:
      batch->(pod,data)  seq->model (sequence parallelism)
      MoE: experts->model, moe_ff at rest ->data, fsdp->data
  train/prefill, ssm families or heads that do not divide "model":
      batch->(pod,data,model)
  decode (all families):
      batch->(pod,data)  kv_seq->model
      MoE: experts->data, moe_ff->model, no fsdp

The serving plane uses the decode rule-set only to find its expert axis:
the base expert GEMMs are independent per expert, so running them over
blocks of experts, each on its own device, is a pure map with no
collective, and each expert's output keeps its bits (``moe.expert_gmm``).
Unlike the reference, the port does not replicate the other weights to
every position: each replicated operation is computed once, on the mesh's
first device, where those weights stay.

``lm_loss`` is the training plane's loss (single device). The
collective-bearing ``make_*_step`` builders, ``batch_specs`` and
``cache_specs`` come with the SPMD steps (ROADMAP A8b).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import ShardingRules
from repro_torch.models.moe import ExpertBlocks, Remote


def rules_for(mesh, kind: str, cfg,
              overrides: Optional[Dict] = None) -> ShardingRules:
    """The rule-set of step ``kind`` ("train", "prefill" or "decode") for
    ``cfg`` over ``mesh``."""
    r: Dict = {}
    model_size = dict(zip(mesh.axis_names, mesh.devices.shape)).get("model",
                                                                    1)
    if kind in ("train", "prefill"):
        # a recurrence forbids seq sharding, and heads that do not divide
        # the model axis would replicate attention under it: both take
        # batch over model instead
        if cfg.is_ssm or cfg.n_heads % model_size != 0:
            r["batch"] = ("pod", "data", "model")
            r["seq"] = None
        else:
            r["batch"] = ("pod", "data")
            r["seq"] = "model"
        r["experts"] = "model"
        r["moe_ff"] = "data"
        r["fsdp"] = "data"
        r["kv_seq"] = None
    elif kind == "decode":
        r["batch"] = ("pod", "data")
        r["seq"] = None
        r["kv_seq"] = "model"
        r["experts"] = "data"
        r["moe_ff"] = "model"
        r["fsdp"] = None
    else:
        raise ValueError(kind)
    if overrides:
        r.update(overrides)
    return ShardingRules(mesh, r)


@dataclasses.dataclass(frozen=True, eq=False)
class ExpertParallelCtx:
    """The serving plane's expert-parallel axis of a (mesh, model) pair:
    ``size`` blocks of experts, block i on ``devices[i]`` (the positions
    along ``axis``, in axis order, at index 0 of every other axis)."""
    mesh: object
    axis: object
    size: int
    devices: Tuple[torch.device, ...]


def _axis_devices(mesh, names) -> Tuple[torch.device, ...]:
    dims = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for idx in itertools.product(*(range(dims[n]) for n in names)):
        at = dict(zip(names, idx))
        out.append(mesh.devices[tuple(at.get(a, 0)
                                      for a in mesh.axis_names)])
    return tuple(out)


def expert_parallel_ctx(mesh, cfg) -> Optional[ExpertParallelCtx]:
    """The expert axis the decode rule-set gives ``cfg`` under ``mesh``,
    or None where it shards nothing (no axis resolves, or it has one
    position): the caller then runs the plain path."""
    rules = rules_for(mesh, "decode", cfg)
    axis = rules.spec(("experts",), (cfg.n_experts,))[0]
    if axis is None:
        return None
    names = axis if isinstance(axis, tuple) else (axis,)
    dims = dict(zip(mesh.axis_names, mesh.devices.shape))
    size = int(np.prod([dims.get(n, 1) for n in names]))
    if size <= 1:
        return None
    return ExpertParallelCtx(mesh=mesh, axis=axis, size=size,
                             devices=_axis_devices(mesh, names))


def shard_serve_params(params, ctx: ExpertParallelCtx):
    """The serving params with the MoE ``gate``/``up``/``down`` weights
    (L, E, d, f) cut into the ctx's expert blocks (``ExpertBlocks``): block
    i is ``w[:, e0:e1]`` on ``ctx.devices[i]``, a view where that is the
    weight's device, else a copy there. A weight whose E does not divide
    stays whole, as does every other weight (on the mesh's first device),
    and a weight already in blocks keeps them. Placement only: every value
    is unchanged."""
    out = dict(params)
    moe = params.get("layers", {}).get("moe")
    if moe is None:
        return out
    moe, remote = dict(moe), Remote()     # one for the three weights
    for name in ("gate", "up", "down"):
        w = moe.get(name)
        if isinstance(w, torch.Tensor) and w.dim() >= 2 \
                and w.shape[1] % ctx.size == 0:
            moe[name] = ExpertBlocks.cut(w, ctx.devices, remote)
    out["layers"] = dict(params["layers"], moe=moe)
    return out


def lm_loss(logits, labels):
    """Masked next-token cross-entropy in f32: labels < 0 take no part;
    the mean over the labelled positions (at least one)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = labels >= 0
    return ((lse - tgt) * mask).sum() / mask.sum().clamp_min(1)
