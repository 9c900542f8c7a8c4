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

``params_as_run`` is what the port's SPMD steps actually hold: they keep
whole on every rank what only the reference's compiler shards (the
attention weights, the vocab; ``steps.step_placements``), so on a mesh it
exceeds ``params``. ``fits_80g`` is held against the total with it.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.distributed import steps as steps_mod
from repro_torch.models import model as model_mod

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
    "params_as_run", "total_as_run", "fits_80g"} of one rank for a step of
    ``kind`` at ``shape`` under ``rules``."""
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
        out["opt_state"] = (2 * 4 * out["params"] // 2  # m+v f32 vs bf16 p
                            if kind == "train" else 0)
    out["total"] = sum(out.values())
    seq = 1 if kind == "decode" else shape.seq_len
    as_run = _tree_device_bytes(params_abs, steps_mod.step_placements(
        cfg, rules, kind, shape.global_batch, seq))
    out["params_as_run"] = as_run
    out["total_as_run"] = (as_run + out["cache"] + out["workspace"]
                           + (4 * as_run if kind == "train" else 0))
    out["fits_80g"] = bool(out["total_as_run"] < CARD_BYTES)
    return out
