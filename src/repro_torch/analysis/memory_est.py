"""Analytic per-rank memory of a step on the H100, the counterpart of
``repro.analysis.memory_est``.

The at-rest bytes of one rank, exact from the layouts: the parameters at
their shard shapes under the step's rules (``model.param_shardings``, the
reference's specs), the decode cache at its shard shapes
(``steps.cache_specs``; ``pos`` and ``cross_len`` are host ints here, the
reference's are 4-byte device scalars) and, for train, AdamW's two f32
moments. Beside them the reference's workspace estimate (activations kept
for the backward, an f32 score tile, the f32 logits).

What the H100 changes: the reference set this beside a host-CPU compile's
``memory_analysis()``, whose bf16->f32 hoisting of loop-invariant weights
and caches inflated it; the port compiles nothing and allocates what it
computes with, so there is no such caveat. ``fits_80g`` holds the total
against one card's 80 GB (the reference's ``fits_16g`` was its 16 GB
accelerator's).

What the port's SPMD steps hold beside that: ``params_as_run``, the
parameters in the layout the steps take (``steps.step_placements``), the
reference's, so equal to ``params``; for train ``grads``, the gradient
tree at the same shards; ``at_use_gather``, the largest layer's weights
as its bodies compute with them (``model.use_layout``: whole, the
sequence-parallel MLP's fsdp dims gathered, the expert weights at their
plan's specs), twice for train (their gradient beside them in the
backward); and ``logits_as_run``, the f32 logits rows of this rank's
tokens over the padded vocab as ``layers.unembed`` makes them, beside
the workspace estimate's vocab-sharded logits. ``total_as_run`` adds
these to ``total``, and ``fits_80g`` is held against it.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.distributed import steps as steps_mod
from repro_torch.distributed.sharding import axes_of, use_rules
from repro_torch.models import model as model_mod
from repro_torch.models.layers import mlp_sp_axes
from repro_torch.models.moe import resolve_moe_plan

CARD_BYTES = 80 * 10**9      # one H100's 80 GB (85.5e9 bytes, less the
#                              driver's and the allocator's share)


def _tree_device_bytes(abstract, placements) -> int:
    if isinstance(abstract, dict):
        return sum(_tree_device_bytes(v, placements[k])
                   for k, v in abstract.items())
    if not isinstance(abstract, torch.Tensor):
        return 0                 # a host int (the cache's pos, cross_len)
    return math.prod(placements.local_shape) * abstract.element_size()


def analytic_device_bytes(cfg, shape, rules, kind: str,
                          kv_quant: bool = False) -> Dict[str, int]:
    """{"params", "cache", "workspace", "opt_state", "total",
    "params_as_run", "grads", "at_use_gather", "logits_as_run",
    "total_as_run", "fits_80g"} of one rank for a step of ``kind`` at ``shape`` under
    ``rules``."""
    params_abs = model_mod.abstract_params(cfg)
    out = {"params": _tree_device_bytes(
        params_abs, model_mod.param_shardings(cfg, rules))}

    mesh_shape = dict(zip(rules.mesh.axis_names, rules.mesh.devices.shape))
    dp = 1
    for a in ("pod", "data"):
        if a in mesh_shape and shape.global_batch % (dp * mesh_shape[a]) == 0:
            dp *= mesh_shape[a]
    tp = mesh_shape.get("model", 1)
    B_loc = max(shape.global_batch // dp, 1)
    d = cfg.d_model

    if kind == "decode":
        cache, c_sh = steps_mod.cache_specs(cfg, shape, rules, kv_quant)
        out["cache"] = _tree_device_bytes(cache, c_sh)
        out["workspace"] = int(B_loc * d * 4 * 8 +
                               B_loc * cfg.vocab_size // max(tp, 1) * 4)
        out["opt_state"] = 0
    else:
        S_loc = shape.seq_len
        if not cfg.is_ssm and shape.seq_len % tp == 0:
            S_loc = shape.seq_len // tp
        elif cfg.is_ssm and shape.global_batch % (dp * tp) == 0:
            B_loc = max(shape.global_batch // (dp * tp), 1)
        act_carry = cfg.n_layers * B_loc * S_loc * d * 2  # bf16 saved inputs
        # chunk workspace: f32 score tile (attention) or chunk tensors (ssm)
        q_chunk = min(512, S_loc)
        H_loc = cfg.n_heads if cfg.n_heads % tp else cfg.n_heads // tp
        score_tile = 4 * B_loc * H_loc * q_chunk * shape.seq_len
        logits = 8 * B_loc * S_loc * (cfg.vocab_size // max(tp, 1))
        out["cache"] = 0
        out["workspace"] = int(act_carry * (2 if kind == "train" else 1)
                               + score_tile + logits)
        # AdamW's m and v in f32, one of each a parameter element
        out["opt_state"] = (8 * out["params"] // params_abs["embed"]
                            .element_size() if kind == "train" else 0)
    out["total"] = sum(out.values())
    seq = 1 if kind == "decode" else shape.seq_len
    out["params_as_run"] = _tree_device_bytes(
        params_abs, steps_mod.step_placements(cfg, rules))
    # the gradient tree value_and_grad returns, at the parameters' shards
    out["grads"] = out["params_as_run"] if kind == "train" else 0
    out["at_use_gather"] = _at_use_bytes(cfg, rules, kind, shape.global_batch,
                                         seq, params_abs["embed"]
                                         .element_size())
    out["logits_as_run"] = _logits_bytes(cfg, shape, rules, kind)
    out["total_as_run"] = (out["total"] - out["params"] + out["params_as_run"]
                           + out["grads"] + out["at_use_gather"]
                           + out["logits_as_run"])
    out["fits_80g"] = bool(out["total_as_run"] < CARD_BYTES)
    return out


def _local_tokens(rules, kind: str, batch: int, seq: int):
    """(batch rows, sequence positions) of this rank's share of global
    activations (batch, seq) of a step of ``kind``."""
    names, dims = (["batch"], [batch]) if kind == "decode" else (
        ["batch", "seq"], [batch, seq])
    loc = [n // rules.size(p) for n, p in zip(dims, rules.spec(names, dims))]
    return loc[0], (loc[1] if kind != "decode" else 1)


def _logits_bytes(cfg, shape, rules, kind) -> int:
    """The f32 logits of this rank's rows as ``layers.unembed`` makes
    them: under a vocab its tokens' axes shard, this rank's columns of the
    gathered rows and the rows the all-to-all returns (twice the rows);
    under one they do not, its columns and the gathered whole."""
    seq = shape.seq_len
    if kind != "decode" and cfg.is_encdec:      # the decoder's tokens
        seq = steps_mod.batch_specs(cfg, shape, rules)["tokens"][0].shape[1]
    B, S = _local_tokens(rules, kind, shape.global_batch, seq)
    V = cfg.padded_vocab
    vax = axes_of(rules.spec(("vocab", None), (V, cfg.d_model))[0])
    n = rules.size(vax)
    rows = 4 * B * S * V
    if n == 1:
        return rows
    tok = sum(rules.token_layout(B, S if kind != "decode" else None), ())
    return 2 * rows if set(vax) & set(tok) else rows + rows // n


def _at_use_bytes(cfg, rules, kind, batch, seq, itemsize) -> int:
    """The largest layer's weights as its bodies compute with them
    (``model.use_layout``): each leaf whose tensor at use is larger than
    its shard at rest, twice for train (its gradient beside it in the
    backward)."""
    with use_rules(rules):
        plan = resolve_moe_plan(cfg, batch, seq, kind) if cfg.is_moe \
            else None
    B, S = _local_tokens(rules, kind, batch, seq)
    sp = mlp_sp_axes(rules, cfg, B, S) if kind != "decode" else None
    sp_fsdp = None if sp is None else tuple(a for a in sp[1:] if a)
    experts = None if plan is None else (plan.ep_axis, plan.ff_axis)
    sizes = dict(zip(rules.mesh.axis_names, rules.mesh.devices.shape))
    specs = model_mod.param_specs(cfg)
    per_layer = max(
        sum(leaf.use_elements(sizes) for leaf in model_mod.use_layout(
            cfg, rules, g, sp_fsdp, experts).values()
            if leaf.use_elements(sizes) != math.prod(leaf.local))
        for g in model_mod.LAYER_GROUPS if g in specs)
    return per_layer * itemsize * (2 if kind == "train" else 1)
