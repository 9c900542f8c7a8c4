"""int8 gradient compression with error feedback, the counterpart of
``repro.training.compression``: per-tensor scaled int8 codes for the
cross-pod gradient all-reduce (``train_step.make_lora_train_step`` with
``compress`` and ``axis_name``), with the quantization residual carried
into the next step so that the transmitted sum tracks the true one."""
from __future__ import annotations

import torch

from repro_torch.training.tree import tree_map

F32 = torch.float32


def quantize(g, err):
    """g + err -> (int8 q, f32 scale, the new residual err')."""
    g = g.to(F32) + err
    amax = g.abs().max()
    scale = amax.clamp_min(1e-30) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    err_new = g - q.to(F32) * scale
    return q, scale, err_new


def dequantize(q, scale):
    return q.to(F32) * scale


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


def _is_tuple(t) -> bool:
    return isinstance(t, tuple)


def compress_tree(grads, errors):
    """-> (a tree of (q, scale) pairs, the new error tree)."""
    qs = tree_map(quantize, grads, errors)
    return (tree_map(lambda t: (t[0], t[1]), qs, is_leaf=_is_tuple),
            tree_map(lambda t: t[2], qs, is_leaf=_is_tuple))


def decompress_tree(q_tree):
    return tree_map(lambda t: dequantize(*t), q_tree, is_leaf=_is_tuple)
