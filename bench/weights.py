"""The benchmark's inputs on the device: base weights and adapter factors
drawn from ``--seed`` by a ``torch.Generator`` on the card, one call a
leaf, in the dtype they are served in and in the port's layouts (its
parameter tree and its ``AdapterPool`` tensors). The same tensors go to
the program and to the plain reference; neither side changes them.

Scales (the benchmark's choice; random weights, so only the regime
matters): every projection keeps unit-scale activations (std
1/sqrt(fan_in)); the router's logits have std ``router_std``, so routing
is decided and not a coin toss; the lm head's logits have std
``logit_std`` whatever the width; each adapter's expert delta is about
``lora_share`` of the base expert output, at its true rank (its lanes past
that rank are exact zeros, as the port's mixed-rank pools hold them).
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch


def _normal(shape, std: float, gen, device, dtype) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    out.normal_(0.0, std, generator=gen)
    return out


def make_params(cfg, scales: Dict, seed: int, device) -> Dict:
    """The port's parameter tree (``models.model.param_specs`` names and
    shapes, MoE decoder) drawn from ``seed``."""
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, L, E, ff = cfg.d_model, cfg.n_layers, cfg.n_experts, cfg.d_ff
    H, KV, hd, Vp = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.padded_vocab

    def draw(shape, std):
        return _normal(shape, std, gen, device, dt)

    layers = {
        "ln1": torch.zeros((L, d), dtype=dt, device=device),
        "ln2": torch.zeros((L, d), dtype=dt, device=device),
        "attn": {"wq": draw((L, d, H * hd), 1 / math.sqrt(d)),
                 "wk": draw((L, d, KV * hd), 1 / math.sqrt(d)),
                 "wv": draw((L, d, KV * hd), 1 / math.sqrt(d)),
                 "wo": draw((L, H * hd, d), 1 / math.sqrt(H * hd))},
        "moe": {"router": draw((L, d, E), scales["router_std"]
                               / math.sqrt(d)),
                "gate": draw((L, E, d, ff), 1 / math.sqrt(d)),
                "up": draw((L, E, d, ff), 1 / math.sqrt(d)),
                "down": draw((L, E, ff, d), 1 / math.sqrt(ff))}}
    return {"embed": draw((Vp, d), 1.0),
            "final_norm": torch.zeros((d,), dtype=dt, device=device),
            "lm_head": draw((Vp, d), scales["logit_std"] / math.sqrt(d)),
            "layers": layers}


def make_adapters(cfg, ranks: Sequence[int], r_pool: int, scale: float,
                  lora_share: float, seed: int, device) -> Dict:
    """{target: {"A": (L, N, E, d_in, r_pool), "B": (L, N, E, r_pool,
    d_out)}} for the expert targets gate, up and down: adapter i uses its
    first ranks[i] lanes, the rest are +0.0. A has std 1/sqrt(d_in); B is
    sized so that scale * (x A) B is ``lora_share`` of a unit output."""
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed ^ 0xADA)
    L, E, N = cfg.n_layers, cfg.n_experts, len(ranks)
    rk = torch.tensor(list(ranks), device=device)
    lane = torch.arange(r_pool, device=device)
    keep = (lane[None, :] < rk[:, None])                     # (N, r)
    b_std = lora_share / scale / torch.sqrt(rk.to(torch.float32))
    dims = {"gate": (cfg.d_model, cfg.d_ff), "up": (cfg.d_model, cfg.d_ff),
            "down": (cfg.d_ff, cfg.d_model)}
    out = {}
    for tgt, (d_in, d_out) in dims.items():
        A = _normal((L, N, E, d_in, r_pool), 1 / math.sqrt(d_in), gen,
                    device, dt)
        A.masked_fill_(~keep[None, :, None, None, :], 0.0)
        B = _normal((L, N, E, r_pool, d_out), 1.0, gen, device, dt)
        B.mul_(b_std.to(dt).reshape(1, N, 1, 1, 1))
        B.masked_fill_(~keep[None, :, None, :, None], 0.0)
        out[tgt] = {"A": A, "B": B}
    return out
