"""Deterministic synthetic token pipeline, sharded per host (numpy only:
the reference's ``repro.training.data``, copied, so that ``batch_at``
gives the same arrays bit for bit).

Serving papers need adapters from somewhere: the train driver fine-tunes
per-tenant LoRA adapters on per-tenant synthetic mixtures. The generator is
stateless-deterministic in (seed, step, host), so a restarted host resumes
at exactly the right batch without coordination — the checkpoint only needs
the step counter (fault-tolerance requirement)."""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    # synthetic structure: repeated n-gram "skills" per tenant make the LoRA
    # fine-tune measurably learnable (loss drops are asserted in tests)
    tenant_id: int = 0
    skill_period: int = 7


def batch_at(cfg: DataConfig, step: int) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, labels) for ``step``; host-sharded on the batch dim."""
    per_host = cfg.global_batch // cfg.n_hosts
    rng = np.random.default_rng(
        (cfg.seed * 1_000_003 + step) * 64 + cfg.host_id)
    shape = (per_host, cfg.seq_len + 1)
    toks = rng.integers(0, cfg.vocab_size, size=shape, dtype=np.int32)
    # inject tenant-specific deterministic structure
    phase = (cfg.tenant_id * 31 + 7) % cfg.skill_period
    idx = np.arange(cfg.seq_len + 1)
    mask = (idx % cfg.skill_period) == phase
    toks[:, mask] = (cfg.tenant_id * 131 + idx[mask]) % cfg.vocab_size
    return toks[:, :-1], toks[:, 1:].copy()


def stream(cfg: DataConfig, start_step: int = 0) -> Iterator:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1
