"""Sharding rule-sets per step kind, the SPMD step builders and the
serving plane's expert parallelism, the counterpart of
``repro.distributed.steps``.

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
Unlike the reference, the serving plane does not replicate the other
weights to every position: each replicated operation is computed once,
on the mesh's first device, where those weights stay.

``lm_loss`` is the training plane's loss (``training.train_step``'s).

The SPMD steps (``make_train_step``, ``make_prefill_step``,
``make_serve_step``, and ``jit_*_step`` which also give the abstract
inputs and the rules) run one process a position of a
``launch.mesh.ProcessMesh``; there is no SPMD compiler, so each process
calls the step on its local shards and the model's sharded bodies write
their collectives out (``models.moe``, ``models.layers``). The token dims
(batch, sequence) are sharded over every axis their rule names, and a
global size that does not divide is refused. The parameters rest in the
reference's layout (``step_placements``, ``model.param_shardings``):
every weight sharded by its logical axes, the attention's qkv_out and
kv_out, the vocab and the fsdp dims included. A layer body gathers its
weights at use (``transformer.weights_at_use``), the MoE takes its expert
weights to its plan's specs, both as ``model.use_layout`` says, and the
embedding and lm head run vocab-parallel. A gather's backward sums the
gradient over the axes that shard the tokens and keeps this rank's
chunk over the others (``sharding.to_spec``). A gradient is then summed
over the token axes its weight is not sharded on (``sum_grads``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import Placement, ShardingRules, \
    axes_of, use_rules
from repro_torch.models import cache as cache_mod
from repro_torch.models import model as model_mod
from repro_torch.models import transformer
from repro_torch.models.moe import ExpertBlocks, Remote
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train_step import _nll_sum, value_and_grad
from repro_torch.training.train_step import lm_loss  # noqa: F401 (callers)
from repro_torch.training.tree import flatten_with_keys


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


# ------------------------------ specs ----------------------------------- #
def batch_specs(cfg, shape, rules: ShardingRules):
    """name -> (meta tensor of the global shape, ``Placement``) for every
    step input, the reference's."""
    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    specs = {}

    def add(name, shp, dtype, axes):
        specs[name] = (torch.empty(shp, dtype=dtype, device="meta"),
                       rules.sharding(axes, shp))

    if shape.kind in ("train", "prefill"):
        S_text = S
        if cfg.frontend:
            S_front = min(cfg.frontend_tokens, S // 2)
            S_text = S - S_front
            add("frontend_emb", (B, S_front, d), torch.bfloat16,
                ("batch", "seq", None))
        add("tokens", (B, S_text), torch.int32, ("batch", "seq"))
        if shape.kind == "train":
            add("labels", (B, S_text), torch.int32, ("batch", "seq"))
    else:
        add("tokens", (B, 1), torch.int32, ("batch", None))
    return specs


def cache_specs(cfg, shape, rules: ShardingRules, kv_quant: bool = False):
    """(the cache as meta tensors, each entry's ``Placement``), the
    reference's; ``pos`` and ``cross_len`` are host ints (placed as
    scalars)."""
    ax = cache_mod.cache_logical_axes(cfg)
    cache = cache_mod.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 kv_quant, device="meta")
    return cache, {k: rules.sharding(ax[k], tuple(getattr(v, "shape", ())))
                   for k, v in cache.items()}


def _check_tokens(rules: ShardingRules, dims, what: str):
    """Refuse global token dims ``dims`` ((name, size) pairs) that are not
    sharded over every axis their rules name (the layers infer the global
    sizes from the local ones so). Returns the local sizes."""
    names = [n for n, _ in dims]
    spec = rules.spec(names, [n for _, n in dims])
    local = [n // rules.size(p) for (_, n), p in zip(dims, spec)]
    seq_name = names[1] if len(names) > 1 else "seq"
    want = rules.token_layout(local[0], local[1] if len(local) > 1 else None,
                              seq_name=seq_name)
    got = tuple(axes_of(p) for p in spec) + ((),) * (2 - len(spec))
    if got != want:
        raise ValueError(
            f"{what}: the global {dict(dims)} must divide over the mesh "
            f"axes their rules name ({dict(zip(names, want))}); got "
            f"{dict(zip(names, got))}")
    return local


def step_placements(cfg, rules: ShardingRules):
    """The parameters' layout the SPMD steps take, every step kind and
    token shape alike: the reference's, every leaf by its logical axes
    under ``rules`` (``model.param_shardings``). The bodies take each
    weight from it to what they compute with (``model.use_layout``). A
    tree of ``Placement``."""
    return model_mod.param_shardings(cfg, rules)


def local_params(params, placements):
    """This rank's shards (views) of global ``params``."""
    if isinstance(params, dict):
        return {k: local_params(v, placements[k]) for k, v in params.items()}
    return placements.local(params)


def whole_params(params, placements):
    """The global parameters from every rank's shards (a collective: every
    rank calls it)."""
    if isinstance(params, dict):
        return {k: whole_params(v, placements[k]) for k, v in params.items()}
    return placements.whole(params)


def _token_group(rules, batch: int, seq: Optional[int]):
    """(the token axes of local activations (batch, seq), in mesh order,
    their process group)."""
    bax, sax = rules.token_layout(batch, seq)
    axes = tuple(a for a in rules.mesh.axis_names if a in bax + sax)
    return axes, (rules.mesh.get_group(axes) if axes else None)


def sum_grads(grads, placements, token_axes, mesh):
    """Each gradient summed over the token axes its weight is not sharded
    on: over those, each rank saw only its own tokens (over the token
    axes a weight is sharded on, its gather's backward summed it)."""
    if isinstance(grads, dict):
        return {k: sum_grads(v, placements[k], token_axes, mesh)
                for k, v in grads.items()}
    own = {a for p in placements.spec for a in axes_of(p)}
    axes = tuple(a for a in token_axes if a not in own)
    return col.all_reduce(grads, mesh.get_group(axes)) if axes else grads


ADAMW_CHUNK = 1 << 25          # elements an in-place update takes at once


@torch.no_grad()
def adamw_(params, grads, opt_state, opt_cfg: opt_mod.AdamWConfig):
    """``opt_mod.update`` applied IN PLACE, ADAMW_CHUNK elements of a leaf
    at a time (it is elementwise: the values are the whole tree's): each
    parameter and its moments are overwritten with their new values (the
    reference's ``jit_train_step`` donates them), so neither a second copy
    of the f32 moments nor a whole leaf's f32 temporaries are alive.
    Returns (params, the state with the new step)."""
    flat_g = flatten_with_keys(grads)
    flat_m, flat_v = (flatten_with_keys(opt_state[k]) for k in ("m", "v"))
    step = opt_state["step"] + 1
    for k, p in flatten_with_keys(params).items():
        g = flat_g.pop(k).reshape(-1)
        ps, ms, vs = (t.view(-1) for t in (p, flat_m[k], flat_v[k]))
        for i in range(0, ps.numel(), ADAMW_CHUNK):
            sl = slice(i, i + ADAMW_CHUNK)
            new_p, new_s = opt_mod.update(
                {"x": ps[sl]}, {"x": g[sl]},
                {"m": {"x": ms[sl]}, "v": {"x": vs[sl]},
                 "step": opt_state["step"]}, opt_cfg)
            ps[sl].copy_(new_p["x"])
            ms[sl].copy_(new_s["m"]["x"])
            vs[sl].copy_(new_s["v"]["x"])
        del g
    return params, dict(opt_state, step=step)


# --------------------------- step builders ------------------------------- #
def make_train_step(cfg, rules: ShardingRules,
                    opt_cfg: opt_mod.AdamWConfig = None):
    """step(params, opt_state, batch) -> (loss, params, opt_state) on this
    rank's shards (``step_placements``): the loss of the global batch,
    every rank's the same. The parameters and moments
    are updated in place (``adamw_``)."""
    opt_cfg = opt_cfg or opt_mod.AdamWConfig()
    mesh = rules.mesh
    place = step_placements(cfg, rules)
    groups = {}         # local (B, S) -> (token axes, their group)

    def step(params, opt_state, batch):
        labels = batch["labels"]
        B, S = labels.shape
        if (B, S) not in groups:
            groups[B, S] = _token_group(rules, B, S)
        token_axes, tg = groups[B, S]
        with use_rules(rules):
            n_labels = col.all_reduce((labels >= 0).sum(), tg)

            def loss_fn(p, batch):
                logits, _ = transformer.forward(
                    p, cfg, batch["tokens"],
                    frontend_emb=batch.get("frontend_emb"), kind="train")
                if cfg.frontend and not cfg.is_encdec:
                    logits = logits[:, -S:]     # the text's positions
                # this rank's share of the global mean
                return _nll_sum(logits, labels) / n_labels.clamp_min(1)

            loss, grads = value_and_grad(loss_fn, params, batch)
            grads = sum_grads(grads, place, token_axes, mesh)
            params, opt_state = adamw_(params, grads, opt_state, opt_cfg)
            loss = col.all_reduce(loss, tg)
        return loss, params, opt_state

    return step


def make_prefill_step(cfg, rules: ShardingRules):
    """step(params, batch) -> this rank's logits (B_l, S_l, Vp) f32."""
    def step(params, batch):
        with use_rules(rules), torch.no_grad():
            logits, _ = transformer.forward(
                params, cfg, batch["tokens"],
                frontend_emb=batch.get("frontend_emb"), kind="prefill")
        return logits

    return step


def make_serve_step(cfg, rules: ShardingRules):
    """Decode step: (params, cache, batch[, lora_ctx]) -> (logits (B_l,
    Vp), cache) on this rank's batch rows and cache slices (written in
    place)."""
    def step(params, cache, batch, lora_ctx=None):
        with use_rules(rules), torch.no_grad():
            return transformer.decode_step(params, cfg, cache,
                                           batch["tokens"],
                                           lora_ctx=lora_ctx)

    return step


def _abstract_batch(specs):
    return {k: v[0] for k, v in specs.items()}


def jit_train_step(cfg, shape, mesh, opt_cfg=None):
    """(step, (params, opt_state, batch) as meta tensors of their global
    shapes, rules) for a train ``shape`` over ``mesh``; the step takes
    local shards (``step_placements``; ``local_params``). No compiler:
    the name is the reference's."""
    rules = rules_for(mesh, "train", cfg)
    specs = batch_specs(cfg, shape, rules)
    _check_tokens(rules, [("batch", shape.global_batch),
                          ("seq", specs["tokens"][0].shape[1])],
                  "jit_train_step")
    abstract = model_mod.abstract_params(cfg)
    opt = {"m": model_mod.abstract_params(cfg, torch.float32),
           "v": model_mod.abstract_params(cfg, torch.float32),
           "step": torch.empty((), dtype=torch.int32, device="meta")}
    return (make_train_step(cfg, rules, opt_cfg),
            (abstract, opt, _abstract_batch(specs)), rules)


def jit_prefill_step(cfg, shape, mesh):
    """(step, (params, batch) as meta tensors, rules) for a prefill
    ``shape`` over ``mesh``."""
    rules = rules_for(mesh, "prefill", cfg)
    specs = batch_specs(cfg, shape, rules)
    _check_tokens(rules, [("batch", shape.global_batch),
                          ("seq", specs["tokens"][0].shape[1])],
                  "jit_prefill_step")
    return (make_prefill_step(cfg, rules),
            (model_mod.abstract_params(cfg), _abstract_batch(specs)), rules)


def jit_serve_step(cfg, shape, mesh, kv_quant=False):
    """(step, (params, cache, batch) as meta tensors, rules) for a decode
    ``shape`` (global batch, cache length) over ``mesh``."""
    rules = rules_for(mesh, "decode", cfg)
    specs = batch_specs(cfg, shape, rules)
    _check_tokens(rules, [("batch", shape.global_batch),
                          ("kv_seq", shape.seq_len)], "jit_serve_step")
    cache, _ = cache_specs(cfg, shape, rules, kv_quant)
    return (make_serve_step(cfg, rules),
            (model_mod.abstract_params(cfg), cache, _abstract_batch(specs)),
            rules)
