"""Logical-axis sharding rules (MaxText-style), the counterpart of
``repro.distributed.sharding``.

Model code names the axes of its activations and weights logically; a
``ShardingRules`` maps each logical name to mesh axes over a
``launch.mesh.Mesh``. ``spec`` resolves a tuple of logical names against
a shape the reference's way: a mesh axis the mesh lacks, or one that does
not divide the dimension, is dropped, and one mesh axis never covers two
dimensions (the first wins). A spec is a tuple, one entry a dimension:
None (replicated), a mesh axis, or a tuple of mesh axes.

The serving plane reads these rules to find its expert-parallel axis
(``distributed.steps.expert_parallel_ctx``). ``constrain`` and
``sharding`` have no counterpart without an SPMD compiler: they come with
the collective-bearing steps (ROADMAP A8b).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]

# Default rules for the production mesh ("data", "model") [+ "pod"].
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),      # global batch
    "seq": "model",                # sequence parallelism for the residual
    "kv_seq": "model",             # decode KV cache sequence dim
    "embed": None,                 # d_model on activations
    "heads": "model",              # attention heads (train/prefill TP)
    "kv_heads": None,              # kv heads (GQA: usually too few)
    "qkv_out": "model",            # fused qkv output dim of weights
    "kv_out": "model",             # fused kv output dim of weights
    "mlp": "model",                # d_ff
    "experts": "model",            # MoE expert dim of weights
    "moe_ff": "data",              # MoE expert hidden dim at rest
    "vocab": "model",              # embedding/lm-head vocab dim
    "fsdp": "data",                # weight dim-0 sharding (ZeRO-3 / FSDP)
    "layers": None,                # stacked-layer leading dim
    "lora_adapters": None,         # adapter pool dim
    "lora_rank": None,
    "conv": None,
    "ssm_state": None,
    "ssm_inner": "model",
    "frontend_seq": None,
}


class ShardingRules:
    """Logical name -> mesh axes over ``mesh`` (anything with
    ``axis_names`` and a ``devices`` array)."""

    def __init__(self, mesh, rules: Optional[Dict[str, MeshAxes]] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        self._axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))

    def _resolve(self, name: Optional[str],
                 dim_size: Optional[int]) -> MeshAxes:
        """The mesh axes of logical ``name`` on a dimension of
        ``dim_size``: the rule's axes the mesh has and that divide it."""
        if name is None:
            return None
        axes = self.rules.get(name)
        if axes is None:
            return None
        if isinstance(axes, str):
            axes = (axes,)
        out, prod = [], 1
        for a in axes:
            if a not in self._axis_sizes:
                continue
            sz = self._axis_sizes[a]
            if dim_size is not None and dim_size % (prod * sz) != 0:
                continue
            out.append(a)
            prod *= sz
        if not out:
            return None
        return tuple(out) if len(out) > 1 else out[0]

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Tuple[MeshAxes, ...]:
        """One entry a dimension; a mesh axis covers one dimension at
        most (the first that resolves to it)."""
        dims = list(shape) if shape is not None else [None] * len(
            logical_axes)
        used, parts = set(), []
        for name, d in zip(logical_axes, dims):
            resolved = self._resolve(name, d)
            if resolved is None:
                parts.append(None)
                continue
            axes = (resolved,) if isinstance(resolved, str) else resolved
            axes = tuple(a for a in axes if a not in used)
            if not axes:
                parts.append(None)
                continue
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
        return tuple(parts)


_tls = threading.local()


def active_rules() -> Optional[ShardingRules]:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_tls, "rules", None)
    _tls.rules = rules
    try:
        yield
    finally:
        _tls.rules = prev


def mesh_axis_size(name: str) -> int:
    """Size of mesh axis ``name`` under the active rules (1 without)."""
    rules = active_rules()
    if rules is None or name not in rules._axis_sizes:
        return 1
    return rules._axis_sizes[name]
