"""Checkpoint / restore with an atomic rename, the counterpart of
``repro.training.checkpoint`` with its on-disk layout:
``<dir>/step_XXXXXXXX/shard_0.npz`` + ``MANIFEST.json``, every leaf
saved whole under its key path (``training.tree``, the reference's
``keystr``), written to a temp dir and renamed (a crashed writer never
corrupts the latest checkpoint). So an f32 checkpoint of either package
restores in the other.

numpy has no bfloat16 without ``ml_dtypes`` (which comes with JAX), so a
bf16 leaf is written as its raw 2-byte words (numpy ``|V2``, what numpy
writes for the reference's bf16 arrays) with "bfloat16" in the manifest,
and read back through the same bits.

``CheckpointManager`` keeps the newest K checkpoints and saves every N
steps (and on demand) on a worker thread."""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.training.tree import flatten_with_keys, tree_map, \
    unflatten_like

BF16 = "bfloat16"


def to_numpy(t) -> np.ndarray:
    """A leaf as a host array (bf16 as its raw 2-byte words)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _dtype_name(a: np.ndarray) -> str:
    return BF16 if a.dtype == np.dtype("V2") else str(a.dtype)


def from_numpy(a: np.ndarray, dtype: str, device=None) -> torch.Tensor:
    """A saved leaf as a tensor on ``device``: "bfloat16" from its raw
    words (or from an ``ml_dtypes`` array), anything else as numpy
    holds it."""
    a = np.array(a, order="C")   # a copy that keeps a 0-d leaf 0-d
    t = torch.from_numpy(a.view(np.int16) if dtype == BF16 else a)
    if dtype == BF16:
        t = t.view(torch.bfloat16)
    return t.to(device) if device is not None else t


def save(ckpt_dir, step: int, tree, host_id: int = 0,
         wait_previous: Optional[threading.Thread] = None) -> pathlib.Path:
    """Atomic checkpoint write; returns the final directory."""
    if wait_previous is not None:
        wait_previous.join()
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    arrays = {k: to_numpy(v) for k, v in flatten_with_keys(tree).items()}
    np.savez(tmp / f"shard_{host_id}.npz", **arrays)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                   for k, v in arrays.items()},
        "n_hosts": 1,
    }
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic on POSIX
    return final


def save_async(ckpt_dir, step, tree, host_id: int = 0) -> threading.Thread:
    """Non-blocking save: the device -> host copy runs on the caller's
    thread (so later in-place updates cannot reach the saved values), the
    serialization on a worker thread (it overlaps the next step)."""
    host_tree = tree_map(to_numpy, tree)
    t = threading.Thread(target=save, args=(ckpt_dir, step, host_tree,
                                            host_id))
    t.start()
    return t


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")]
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, target_tree, device=None):
    """The checkpoint of ``step`` in the structure of ``target_tree``:
    each leaf a tensor of the saved dtype, on ``device`` (default: the
    target leaf's device)."""
    final = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((final / "MANIFEST.json").read_text())["leaves"]
    out = {}
    with np.load(final / "shard_0.npz") as data:
        for key, ref in flatten_with_keys(target_tree).items():
            dev = device if device is not None else \
                (ref.device if isinstance(ref, torch.Tensor) else None)
            out[key] = from_numpy(data[key], manifest[key]["dtype"], dev)
    return unflatten_like(target_tree, out)


class CheckpointManager:
    def __init__(self, ckpt_dir, every: int = 100, keep: int = 3):
        self.dir = pathlib.Path(ckpt_dir)
        self.every = every
        self.keep = keep
        self._pending: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree, force: bool = False):
        if not force and (step == 0 or step % self.every):
            return
        if self._pending is not None:
            self._pending.join()
        self._pending = save_async(self.dir, step, tree)
        self._gc()

    def finalize(self):
        if self._pending is not None:
            self._pending.join()
        self._gc()

    def _gc(self):
        steps = sorted(p for p in self.dir.glob("step_*"))
        for p in steps[: -self.keep]:
            shutil.rmtree(p, ignore_errors=True)
