"""Parameters of every family, the counterpart of ``repro.models.model``:
the same tree of names, shapes and init kinds (``param_specs``), drawn on
the target device from a ``torch.Generator``. Per-layer leaves carry a
leading layer dim (L), or (G, every) for the hybrid's mamba stack.

  embed (Vp, d) | final_norm (d,) | lm_head (Vp, d) unless tied
  dense, moe, vlm layers: ln1, ln2 (L, d) | attn: wq (L, d, H*hd),
          wk/wv (L, d, KV*hd), wo (L, H*hd, d), bq/bk/bv with qkv_bias
          moe: router (L, d, E), gate/up (L, E, d, ff), down (L, E, ff, d)
          mlp (dense, vlm): gate/up (L, d, ff), down (L, ff, d); no gate
          when ``gated_mlp`` is False
  ssm (rwkv6) layers: mu_r/k/v/g/w, cmu_k/r, w0, u, ln_w, ln_b, ln1, ln2
          (L, d) | wr/wk/wv/wg/wo, cr (L, d, d) | w1 (L, d, 64),
          w2 (L, 64, d) | ck (L, d, ff), cv (L, ff, d)
  hybrid layers (G, every, ...): in_proj (d, 2di+2N+nh), conv_w (cw,
          di+2N), A_log/dt_bias/D (nh,), norm (di,), out_proj (di, d) |
          shared_attn: ln1, ln2 (d,), attn and mlp without a layer dim
  audio: enc_layers {ln1, ln2, attn, mlp} (n_enc ...) | enc_norm (d,) |
          layers {ln1, ln2, ln3, attn, cross, mlp} (L ...)

Under sharding rules every leaf rests as ``param_shardings`` lays it out
(the reference's layout); ``use_layout`` says what a layer body computes
with instead, and ``LeafUse.take`` takes a shard there.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import axes_of, to_spec

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
    init: str = "normal"   # normal | zeros | ones | small
    axes: Tuple[Any, ...] = ()   # logical axis names (None = replicated)


def _attn_specs(cfg, Ls: Tuple[int, ...], pa=("layers",)) -> Dict[str, PSpec]:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sp = {"wq": PSpec(Ls + (d, H * hd), axes=pa + ("fsdp", "qkv_out")),
          "wk": PSpec(Ls + (d, KV * hd), axes=pa + ("fsdp", "kv_out")),
          "wv": PSpec(Ls + (d, KV * hd), axes=pa + ("fsdp", "kv_out")),
          "wo": PSpec(Ls + (H * hd, d), axes=pa + ("qkv_out", "fsdp"))}
    if cfg.qkv_bias:
        sp.update(bq=PSpec(Ls + (H * hd,), "zeros", pa + ("qkv_out",)),
                  bk=PSpec(Ls + (KV * hd,), "zeros", pa + ("kv_out",)),
                  bv=PSpec(Ls + (KV * hd,), "zeros", pa + ("kv_out",)))
    return sp


def _mlp_specs(cfg, Ls: Tuple[int, ...], pa=("layers",)) -> Dict[str, PSpec]:
    d, ff = cfg.d_model, cfg.d_ff
    sp = {"up": PSpec(Ls + (d, ff), axes=pa + ("fsdp", "mlp")),
          "down": PSpec(Ls + (ff, d), axes=pa + ("mlp", "fsdp"))}
    if cfg.gated_mlp:
        sp["gate"] = PSpec(Ls + (d, ff), axes=pa + ("fsdp", "mlp"))
    return sp


def _moe_specs(cfg, L: int) -> Dict[str, PSpec]:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    gu = ("layers", "experts", None, "moe_ff")
    sp = {"router": PSpec((L, d, E), "small", ("layers", None, None)),
          "up": PSpec((L, E, d, ff), axes=gu),
          "down": PSpec((L, E, ff, d),
                        axes=("layers", "experts", "moe_ff", None))}
    if cfg.gated_mlp:
        sp["gate"] = PSpec((L, E, d, ff), axes=gu)
    return sp


def _mamba_specs(cfg, Ls: Tuple[int, ...]) -> Dict[str, PSpec]:
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    pa = ("layers",) + (None,) * (len(Ls) - 1)
    return {
        "in_proj": PSpec(Ls + (d, 2 * di + 2 * N + nh),
                         axes=pa + ("fsdp", "ssm_inner")),
        "conv_w": PSpec(Ls + (cfg.ssm_conv, di + 2 * N),
                        axes=pa + ("conv", "ssm_inner")),
        "A_log": PSpec(Ls + (nh,), "ones", pa + (None,)),
        "dt_bias": PSpec(Ls + (nh,), "zeros", pa + (None,)),
        "D": PSpec(Ls + (nh,), "ones", pa + (None,)),
        "norm": PSpec(Ls + (di,), "zeros", pa + ("ssm_inner",)),
        "out_proj": PSpec(Ls + (di, d), axes=pa + ("ssm_inner", "fsdp")),
    }


def _rwkv_specs(cfg, L: int) -> Dict[str, PSpec]:
    d, ff = cfg.d_model, cfg.d_ff
    pa = ("layers",)
    sp = {mu: PSpec((L, d), "zeros", pa + (None,)) for mu in (
        "mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "cmu_k", "cmu_r")}
    sp.update({w: PSpec((L, d, d), axes=pa + ("fsdp", "ssm_inner"))
               for w in ("wr", "wk", "wv", "wg", "wo")})
    sp.update(w0=PSpec((L, d), "zeros", pa + (None,)),
              w1=PSpec((L, d, 64), "small", pa + ("fsdp", None)),
              w2=PSpec((L, 64, d), "small", pa + (None, None)),
              u=PSpec((L, d), "zeros", pa + (None,)),
              ln_w=PSpec((L, d), "ones", pa + (None,)),
              ln_b=PSpec((L, d), "zeros", pa + (None,)),
              ck=PSpec((L, d, ff), axes=pa + ("fsdp", "mlp")),
              cv=PSpec((L, ff, d), axes=pa + ("mlp", "fsdp")),
              cr=PSpec((L, d, d), axes=pa + ("fsdp", None)),
              ln1=PSpec((L, d), "zeros", pa + ("embed",)),
              ln2=PSpec((L, d), "zeros", pa + ("embed",)))
    return sp


def param_specs(cfg) -> Dict[str, Any]:
    """The tree of ``PSpec``s (shape, init kind, logical axes) of every
    parameter, the reference's ``param_specs``."""
    d, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    specs: Dict[str, Any] = {"embed": PSpec((V, d), axes=("vocab", None)),
                             "final_norm": PSpec((d,), "zeros", ("embed",))}
    if not cfg.tie_embeddings:
        specs["lm_head"] = PSpec((V, d), axes=("vocab", None))

    def norms(n, Ls):
        pa = ("layers",) if Ls else ()
        return {f"ln{i}": PSpec(Ls + (d,), "zeros", pa + ("embed",))
                for i in range(1, n + 1)}

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        specs["layers"] = {**norms(2, (L,)), "attn": _attn_specs(cfg, (L,))}
        if cfg.is_moe:
            specs["layers"]["moe"] = _moe_specs(cfg, L)
        else:
            specs["layers"]["mlp"] = _mlp_specs(cfg, (L,))
    elif fam == "ssm" and cfg.rwkv:
        specs["layers"] = _rwkv_specs(cfg, L)
    elif fam == "hybrid":
        every = cfg.shared_attn_every
        specs["layers"] = _mamba_specs(cfg, (L // every, every))
        specs["shared_attn"] = {**norms(2, ()),
                                "attn": _attn_specs(cfg, (), ()),
                                "mlp": _mlp_specs(cfg, (), ())}
    elif fam == "audio":
        E = cfg.n_enc_layers
        specs["enc_layers"] = {**norms(2, (E,)),
                               "attn": _attn_specs(cfg, (E,)),
                               "mlp": _mlp_specs(cfg, (E,))}
        specs["enc_norm"] = PSpec((d,), "zeros", ("embed",))
        specs["layers"] = {**norms(3, (L,)), "attn": _attn_specs(cfg, (L,)),
                           "cross": _attn_specs(cfg, (L,)),
                           "mlp": _mlp_specs(cfg, (L,))}
    else:
        raise ValueError(fam)
    return specs


def _map_specs(fn, tree):
    if isinstance(tree, PSpec):
        return fn(tree)
    return {k: _map_specs(fn, v) for k, v in tree.items()}


def abstract_params(cfg, dtype=None):
    """The parameters as meta-device tensors of their global shapes (the
    reference's ``ShapeDtypeStruct`` tree): shapes and dtypes, no
    memory."""
    dt = resolve_dtype(dtype or cfg.dtype)
    return _map_specs(lambda s: torch.empty(s.shape, dtype=dt,
                                            device="meta"), param_specs(cfg))


def param_shardings(cfg, rules):
    """Each parameter's ``Placement`` under ``rules`` (the reference's
    ``NamedSharding`` tree: the same specs)."""
    return _map_specs(lambda s: rules.sharding(s.axes, s.shape),
                      param_specs(cfg))


EXPERT_WEIGHTS = ("gate", "up", "down")      # a "moe" group's, per expert
LAYER_GROUPS = ("layers", "enc_layers", "shared_attn")


def layer_lead(cfg, group: str) -> int:
    """The leading layer dims of a leaf of ``param_specs(cfg)[group]``."""
    if group == "shared_attn":
        return 0
    return 2 if group == "layers" and cfg.family == "hybrid" else 1


class LeafUse(NamedTuple):
    """One layer's leaf (its layer dims dropped): its global ``shape``,
    its ``rest`` spec (the reference's layout) and ``local`` shard shape,
    the ``use`` spec its body computes with, and that ``body``: "layer"
    (``transformer.weights_at_use``), "moe" or "mlp"."""
    shape: Tuple[int, ...]
    rest: Tuple
    local: Tuple[int, ...]
    use: Tuple
    body: str

    def use_elements(self, mesh_sizes: Dict[str, int]) -> int:
        """The elements of this rank's tensor at ``use``."""
        return math.prod(n // math.prod(mesh_sizes[a] for a in axes_of(p))
                         for n, p in zip(self.shape, self.use))

    def take(self, t, mesh, token_axes, what: str):
        """``t``, this rank's shard at ``rest``, at ``use``
        (``sharding.to_spec``); a tensor of another shape is refused."""
        if tuple(t.shape) != self.local:
            raise ValueError(f"{what}: this rank's shard is {self.local} "
                             f"under the step's layout {self.rest}; got "
                             f"{tuple(t.shape)}")
        return to_spec(t, self.rest, self.use, mesh, token_axes)


@functools.lru_cache(maxsize=256)
def use_layout(cfg, rules, group: str, sp_fsdp: Optional[Tuple] = None,
               experts: Optional[Tuple] = None) -> Dict[tuple, LeafUse]:
    """{path: ``LeafUse``} of each leaf of one layer of
    ``param_specs(cfg)[group]`` under ``rules``: the one place that says
    what a layer body computes with.

      - the MoE's expert weights (a "moe" group's ``EXPERT_WEIGHTS``), by
        the MoE body: over its plan's ``experts`` = (ep axis, ff axis),
        (ep, None, ff) for gate/up and (ep, ff, None) for down; at rest
        where no plan is given;
      - the MLP's weights where it runs sequence-parallel (``sp_fsdp``,
        the fsdp axes it gathers, a tuple; None where it does not), by the
        MLP body: their rest spec without those axes;
      - every other leaf whole, by the layer."""
    lead = layer_lead(cfg, group)
    out = {}

    def walk(tree, path):
        if not isinstance(tree, PSpec):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        pl = rules.sharding(tree.axes, tree.shape)
        if any(pl.spec[:lead]):
            raise ValueError(f"{group}/{'/'.join(path)}: a layer dim is "
                             f"sharded ({pl.spec})")
        rest = pl.spec[lead:]
        if path[-2:-1] == ("moe",) and path[-1] in EXPERT_WEIGHTS:
            body = "moe"
            use = rest if experts is None else (
                (experts[0], experts[1], None) if path[-1] == "down"
                else (experts[0], None, experts[1]))
        elif sp_fsdp is not None and path[0] == "mlp":
            body = "mlp"
            use = tuple(None if p is not None and set(axes_of(p)) <= set(
                sp_fsdp) else p for p in rest)
        else:
            body, use = "layer", (None,) * len(rest)
        out[path] = LeafUse(tree.shape[lead:], rest, pl.local_shape[lead:],
                            use, body)

    walk(param_specs(cfg)[group], ())
    return out


def _make(spec: PSpec, dtype, device, gen) -> torch.Tensor:
    if spec.init in ("zeros", "ones"):
        fill = torch.zeros if spec.init == "zeros" else torch.ones
        return fill(spec.shape, dtype=dtype, device=device)
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
