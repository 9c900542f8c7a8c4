"""Parameters of the decoder LM, the counterpart of ``repro.models.model``
for the slot families (dense, moe, vlm): the same tree of names and
shapes (``param_specs``), drawn on the target device from a
``torch.Generator``.

  embed (Vp, d) | final_norm (d,) | lm_head (Vp, d) unless tied
  layers: ln1, ln2 (L, d) | attn: wq (L, d, H*hd), wk/wv (L, d, KV*hd),
          wo (L, H*hd, d), bq/bk/bv with qkv_bias
          moe: router (L, d, E), gate/up (L, E, d, ff), down (L, E, ff, d)
          mlp (dense, vlm): gate/up (L, d, ff), down (L, ff, d); no gate
          when ``gated_mlp`` is False
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import SLOT_FAMILIES

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another (the CPU tests pass ``device="cpu"``)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the card "
                           "by default; pass device='cpu' to run on the CPU")
    return dev


def resolve_dtype(dtype) -> torch.dtype:
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


class PSpec(NamedTuple):
    shape: Tuple[int, ...]
    init: str = "normal"   # normal | zeros | small


def param_specs(cfg) -> Dict[str, Any]:
    if cfg.family not in SLOT_FAMILIES:
        raise ValueError(f"the port serves the {', '.join(SLOT_FAMILIES)} "
                         f"families, not '{cfg.family}' (ROADMAP A7d)")
    d, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    E, ff = cfg.n_experts, cfg.d_ff
    attn = {"wq": PSpec((L, d, H * hd)), "wk": PSpec((L, d, KV * hd)),
            "wv": PSpec((L, d, KV * hd)), "wo": PSpec((L, H * hd, d))}
    if cfg.qkv_bias:
        attn.update(bq=PSpec((L, H * hd), "zeros"),
                    bk=PSpec((L, KV * hd), "zeros"),
                    bv=PSpec((L, KV * hd), "zeros"))
    if cfg.is_moe:
        ffn = {"router": PSpec((L, d, E), "small"),
               "up": PSpec((L, E, d, ff)), "down": PSpec((L, E, ff, d))}
        if cfg.gated_mlp:
            ffn["gate"] = PSpec((L, E, d, ff))
    else:
        ffn = {"up": PSpec((L, d, ff)), "down": PSpec((L, ff, d))}
        if cfg.gated_mlp:
            ffn["gate"] = PSpec((L, d, ff))
    specs: Dict[str, Any] = {
        "embed": PSpec((V, d)),
        "final_norm": PSpec((d,), "zeros"),
        "layers": {"ln1": PSpec((L, d), "zeros"), "ln2": PSpec((L, d), "zeros"),
                   "attn": attn, "moe" if cfg.is_moe else "mlp": ffn},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = PSpec((V, d))
    return specs


def _make(spec: PSpec, dtype, device, gen) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    scale = 0.02 if spec.init == "normal" else 0.006
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = min(scale, 1.0 / np.sqrt(max(fan_in, 1)))
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    # one leading slice at a time: the f32 draw of a full-width expert stack
    # would need twice the bf16 tensor's memory
    for i in range(spec.shape[0] if len(spec.shape) >= 3 else 1):
        dst = out[i] if len(spec.shape) >= 3 else out
        dst.copy_(torch.randn(dst.shape, generator=gen, dtype=torch.float32,
                              device=device) * scale)
    return out


def init_params(cfg, seed: int = 0, dtype=None, device=None):
    """Random parameters from ``seed`` (the reference's init scales), made
    on ``device`` (default: the CUDA card). Returns a nested dict."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype or cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def walk(tree):
        if isinstance(tree, PSpec):
            return _make(tree, dt, dev, gen)
        return {k: walk(v) for k, v in tree.items()}

    return walk(param_specs(cfg))


def layer_params(layers: dict, l: int) -> dict:
    """Views of layer ``l`` of the stacked ``params["layers"]`` tree."""
    return {k: (layer_params(v, l) if isinstance(v, dict) else v[l])
            for k, v in layers.items()}
