"""Numpy -> torch bridge for parity checks against the JAX reference.

The reference's parameters, adapter pools and server slot pools arrive as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, ...)``
on the caller's side); these helpers turn them into the port's tensors.
The training state (an adapter tree, the AdamW state {"m", "v", "step"})
goes both ways (``train_state_from`` / ``train_state_to_numpy``).
This module never imports JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapter import AdapterPool
from repro_torch.training.tree import tree_map


def config_from(ref_cfg) -> ModelConfig:
    """The port's ModelConfig with the same values as a reference config
    (read attribute by attribute)."""
    return ModelConfig(**{f.name: getattr(ref_cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def to_tensor(a, device="cpu", dtype: Optional[torch.dtype] = None):
    """One numpy array (any float type, bfloat16 included) as a tensor.
    Floats become ``dtype`` (default float32); integers stay integers."""
    arr = np.asarray(a)
    if arr.dtype.kind in "iub":
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
    return t.to(device=device, dtype=dtype or torch.float32)


def _host_int(a) -> bool:
    return np.ndim(a) == 0 and np.asarray(a).dtype.kind in "iu"


def cache_from(ref_cache_np, device="cpu"):
    """A static-batch cache of the port (``cache.init_cache``'s layout)
    from a reference cache as numpy arrays: ``pos`` and ``cross_len``
    become host ints; int8 codes, their f32 scales and the hybrid's int32
    ``apos`` keep their dtypes; bf16 arrays stay bf16, f32 stay f32."""
    out = {}
    for name, a in ref_cache_np.items():
        if _host_int(a):
            out[name] = int(a)
            continue
        arr = np.asarray(a)
        bf16 = arr.dtype.name == "bfloat16"
        out[name] = to_tensor(arr, device,
                              torch.bfloat16 if bf16 else torch.float32)
    return out


def cache_to_numpy(cache):
    """The port's static-batch cache as numpy: tensors as arrays (bf16 as
    f32, since numpy has no bf16; int8 codes stay int8), ints as int32
    scalars, as the reference's ``pos``."""
    return {name: (np.int32(t) if isinstance(t, int) else
                   t.detach().cpu().to(torch.float32).numpy()
                   if t.dtype == torch.bfloat16 else t.detach().cpu().numpy())
            for name, t in cache.items()}


def tree_to_tensors(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """Nested dicts of numpy arrays -> the same dicts of tensors."""
    if isinstance(tree, dict):
        return {k: tree_to_tensors(v, device, dtype) for k, v in tree.items()}
    return to_tensor(tree, device, dtype)


def adapter_pool(cfg, tensors, rank: int, scale: float,
                 ranks: Optional[Sequence[int]] = None, device="cpu",
                 dtype: Optional[torch.dtype] = None) -> AdapterPool:
    """The port's AdapterPool from the reference pool's fields (its
    ``tensors`` as numpy arrays)."""
    t = tree_to_tensors(tensors, device, dtype)
    n = next(iter(t.values()))["A"].shape[1]
    return AdapterPool(cfg, n, int(rank), float(scale), t,
                       tuple(int(r) for r in ranks) if ranks else None)


def load_server_pool(server, pool_np) -> None:
    """Copy a reference ``LoRAServer.pool`` (numpy arrays of the same
    (y, L_stage, M, E, ...) shapes) into the port server's slot pools."""
    for name, buf in server.pool.items():
        src = to_tensor(pool_np[name], buf.device, buf.dtype)
        if tuple(src.shape) != tuple(buf.shape):
            raise ValueError(f"{name}: {tuple(src.shape)} vs "
                             f"{tuple(buf.shape)}")
        buf.copy_(src)


def _state_leaf(a, device):
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr.astype(np.float32))).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def train_state_from(tree_np, device="cpu"):
    """A training-state tree of numpy arrays (the reference's adapter or
    params, its AdamW state) as the port's tensors: each leaf keeps its
    dtype (bfloat16 included) and its shape (0-d ``step`` too)."""
    return tree_map(lambda a: _state_leaf(a, device), tree_np)


def train_state_to_numpy(tree):
    """The port's training-state tree as numpy arrays for the reference
    (bf16 as f32, since numpy has no bf16)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16
                else t).numpy()
    return tree_map(leaf, tree)
