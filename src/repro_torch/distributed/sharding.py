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
(``distributed.steps.expert_parallel_ctx``). The SPMD steps
(``distributed.steps``) read them over a ``launch.mesh.ProcessMesh``:
each process holds its local shards, so a spec says which slice of a
dimension a rank holds (``sharding`` gives that ``Placement``); the
reference's ``constrain``, a layout request to its compiler, has no
counterpart, as every tensor already is its local shard.
``token_layout`` gives the mesh axes the activations' batch and sequence
dims are sharded over, from their local sizes (the steps shard a token
dim over every axis its rule names, and refuse a global size that does
not divide).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.distributed import collectives as col

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

    def sharding(self, logical_axes: Sequence[Optional[str]],
                 shape: Sequence[int]) -> "Placement":
        """Where each rank's shard of a (global) ``shape`` lies."""
        return Placement(self.mesh, self.spec(logical_axes, shape),
                         tuple(int(d) for d in shape))

    def size(self, axes) -> int:
        """The number of positions along ``axes`` (None, a name or a
        tuple; 1 for a name the mesh lacks)."""
        return int(math.prod(self._axis_sizes.get(a, 1)
                             for a in axes_of(axes)))

    def token_layout(self, batch: int, seq: Optional[int] = None,
                     seq_name: str = "seq"):
        """(batch axes, seq axes) as tuples, for activations whose LOCAL
        batch and sequence sizes are ``batch`` and ``seq``: each dim
        sharded over every axis of its rule the mesh has (the batch's
        first), so the global size is the local one times their sizes."""
        names = ["batch"] + ([seq_name] if seq is not None else [])
        local = [batch] + ([seq] if seq is not None else [])
        glob, used = [], set()
        for name, n in zip(names, local):
            axes = [a for a in axes_of(self.rules.get(name))
                    if a in self._axis_sizes and a not in used]
            used.update(axes)
            glob.append(n * self.size(tuple(axes)))
        spec = self.spec(names, glob)
        out = tuple(axes_of(p) for p in spec)
        return out if seq is not None else (out[0], ())


def axes_of(entry) -> Tuple[str, ...]:
    """A spec entry (None, a mesh axis or a tuple of them) as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A global ``shape`` laid out by ``spec`` over ``mesh``: dim i is cut
    into ``size(spec[i])`` equal slices along its mesh axes, the first
    axis major (the reference's ``NamedSharding``)."""
    mesh: object
    spec: Tuple
    shape: Tuple[int, ...]

    @property
    def local_shape(self) -> Tuple[int, ...]:
        sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        return tuple(d // int(math.prod(sizes[a] for a in axes_of(p)))
                     for d, p in zip(self.shape, self.spec))

    def local(self, t):
        """This rank's slice of the global tensor ``t`` (a view), on a
        ``ProcessMesh``."""
        if tuple(t.shape) != self.shape:
            raise ValueError(f"placement of {self.shape} given a tensor of "
                             f"{tuple(t.shape)}")
        for dim, (p, n) in enumerate(zip(self.spec, self.local_shape)):
            if axes_of(p):
                t = t.narrow(dim, self.mesh.coord(axes_of(p)) * n, n)
        return t

    @torch.no_grad()
    def whole(self, t):
        """The global tensor from every rank's shard ``t`` (a collective
        over each sharded dim's axes: every rank calls it)."""
        for dim, p in enumerate(self.spec):
            if axes_of(p):
                t = col.all_gather(t, self.mesh.get_group(axes_of(p)), dim)
        return t


def to_spec(t, have, want, mesh, token_axes=()):
    """``t``, this rank's shard of a tensor laid out by spec ``have`` over
    ``mesh``, as its shard under spec ``want``: each dim whose axes differ
    is all-gathered over its ``have`` axes, then cut to this rank's slice
    of its ``want`` axes. The gradient of a gather over an axis that
    shards the tokens (``token_axes``) or the result (an axis of
    ``want``) is reduce-scattered: there each rank's is a part of it. Over
    any other axis what follows is replicated, so each rank keeps its
    chunk (``all_gather_replicated``). A cut over an axis that shards
    neither ``have`` (a dim of it) nor the tokens leaves each rank the gradient of its
    slice only, so that gradient is summed over it (``col.sum_grad``);
    over a token axis ``steps.sum_grads`` sums it."""
    parts = set(token_axes) | {a for p in want for a in axes_of(p)}
    rest = {a for p in have for a in axes_of(p)}
    for dim, (h, w) in enumerate(zip(have, want)):
        h, w = axes_of(h), axes_of(w)
        if h == w:
            continue
        runs = []           # the innermost axes first, alike ones at once
        for a in reversed(h):
            if runs and runs[-1][0] == (a in parts):
                runs[-1][1].insert(0, a)
            else:
                runs.append((a in parts, [a]))
        for summed, axes in runs:
            g = mesh.get_group(tuple(axes))
            t = (col.all_gather if summed else col.all_gather_replicated)(
                t, g, dim)
        if w:
            cut = tuple(a for a in w if a not in rest and a not in token_axes)
            if cut:
                t = col.sum_grad(t, mesh.get_group(cut))
            n = t.shape[dim] // mesh.size(w)
            t = t.narrow(dim, mesh.coord(w) * n, n).contiguous()
    return t


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
