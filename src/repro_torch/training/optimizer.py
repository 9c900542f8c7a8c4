"""AdamW with a cosine schedule, the counterpart of
``repro.training.optimizer``: f32 moments, the reference's order of
operations, and a trainable mask for LoRA-only fine-tuning (base weights
frozen: their moments are f32 scalars and they are returned unchanged).
Parameters, gradients and moments are trees of tensors
(``training.tree``); the state's ``step`` is an int32 scalar tensor."""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.training.tree import leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int or an int tensor), f32:
    linear warm-up, then a cosine down to ``min_lr_frac`` of ``lr``."""
    s = torch.as_tensor(step).to(F32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def init(params, mask=None):
    """Zero f32 moments shaped like ``params`` (scalars where ``mask`` is
    False) and step 0, on the parameters' device."""
    def zeros(p, m=True):
        return torch.zeros(p.shape if m else (), dtype=F32, device=p.device)

    rest = () if mask is None else (mask,)
    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params, *rest),
            "v": tree_map(zeros, params, *rest),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def update(params, grads, state, cfg: AdamWConfig, mask=None):
    """One AdamW step -> (new params, new state). ``grads`` has the
    structure of ``params``; with ``mask``, leaves marked False keep
    their value and moments (their gradient may be None)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.to(F32))
    bc2 = 1 - torch.pow(b2, step.to(F32))

    def upd(p, g, m, v, trainable=True):
        if not trainable:
            return p, m, v
        g = g.to(F32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) \
            + cfg.weight_decay * p.to(F32)
        return (p.to(F32) - lr * delta).to(p.dtype), m, v

    rest = () if mask is None else (mask,)
    # a masked-out leaf may have no gradient: give the mapping a stand-in
    grads = tree_map(lambda g, p: p if g is None else g, grads, params,
                     is_leaf=lambda t: t is None)
    out = tree_map(upd, params, grads, state["m"], state["v"], *rest)

    def pick(i):
        return tree_map(lambda t: t[i], out,
                        is_leaf=lambda t: isinstance(t, tuple))

    return pick(0), {"m": pick(1), "v": pick(2), "step": step}
