"""Decode-time caches, the counterpart of ``repro.models.cache``.

The slot engine's KV, in two layouts:

  paged pool : k/v (L, n_pages, page_size, KV, hd)
  dense slab : k/v (L, n_slots, max_len, KV, hd)

In the pool a page id addresses the same block in every layer, so one
slot's block table is one int32 row of ceil(max_len / page_size) entries
(-1 = unallocated), and KV memory follows the tokens actually held. In the
slab every slot owns max_len rows, whatever its request needs.

The static batch's caches (``init_cache``), one dict per batch:

  dense/moe/vlm : k/v           (L, B, S, KV, hd) [+ k_scale/v_scale
                                 (L, B, S, KV, 1) f32 for int8]
  ssm (rwkv6)   : tm/cm         (L, B, d)          wkv (L, B, H, hd, hd) f32
  hybrid        : h             (G, every, B, nh, hd, N) f32
                  conv          (G, every, B, cw-1, ch)
                  ak/av         (G, B, W, KV, hd)   ring-buffer window KV
                  apos          (W,) int32 absolute position per ring slot
  audio         : k/v (self, int8 as above) + ck/cv (L, B, cross_kv_len,
                  KV, hd) (cross, filled by the caller) + cross_len (int)
  all           : pos           (int) tokens already in the cache

``pos`` and ``cross_len`` are host ints: the static batch shares one
position, and a device scalar would be read back at every use.

int8 KV: one max-abs scale per (layer, row, position, kv-head).
"""
from __future__ import annotations

from typing import Dict

import torch

KV_DTYPE = torch.bfloat16
F32 = torch.float32


def kv_dtype(quant: bool) -> torch.dtype:
    return torch.int8 if quant else KV_DTYPE


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` KV rows (0 tokens -> 0 pages)."""
    return max(0, -(-int(n_tokens) // int(page_size)))


def init_paged_cache(cfg, n_pages: int, page_size: int, dtype=None,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """Zeroed block pools {"k", "v"} for the attention families."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"paged KV cache supports dense/moe/vlm, not "
                         f"'{cfg.family}'")
    shp = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or KV_DTYPE
    return {"k": torch.zeros(shp, dtype=dt, device=device),
            "v": torch.zeros(shp, dtype=dt, device=device)}


def init_cache(cfg, batch: int, max_len: int, kv_quant: bool = False,
               dtype=None, device="cpu") -> Dict:
    """The zeroed cache of a static batch of ``batch`` rows and ``max_len``
    positions, for every family (the layouts above). The dense slab of the
    slot engine is its "k"/"v" ({"pos": 0} beside them). ``dtype``
    overrides the KV and state dtype (default bf16, int8 KV with
    ``kv_quant``)."""
    L, KV, hd, d = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    dt = dtype or kv_dtype(kv_quant)
    sdt = dtype or KV_DTYPE

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    c: Dict = {"pos": 0}
    fam = cfg.family
    if fam in ("dense", "moe", "vlm", "audio"):
        shp = (L, batch, max_len, KV, hd)
        c["k"], c["v"] = zeros(shp, dt), zeros(shp, dt)
        if kv_quant:
            c["k_scale"] = zeros(shp[:-1] + (1,), F32)
            c["v_scale"] = zeros(shp[:-1] + (1,), F32)
        if fam == "audio":
            cshp = (L, batch, cfg.cross_kv_len, KV, hd)
            c["ck"], c["cv"] = zeros(cshp, sdt), zeros(cshp, sdt)
            c["cross_len"] = 0
    elif fam == "ssm" and cfg.rwkv:
        c["tm"], c["cm"] = zeros((L, batch, d), sdt), zeros((L, batch, d), sdt)
        c["wkv"] = zeros((L, batch, cfg.n_heads, hd, hd), F32)
    elif fam == "hybrid":
        every = cfg.shared_attn_every
        G = L // every
        di, N = cfg.d_inner, cfg.ssm_state
        nh = di // cfg.ssm_head_dim
        W = min(cfg.sliding_window or max_len, max_len)
        c["h"] = zeros((G, every, batch, nh, cfg.ssm_head_dim, N), F32)
        c["conv"] = zeros((G, every, batch, cfg.ssm_conv - 1, di + 2 * N), sdt)
        c["ak"] = zeros((G, batch, W, KV, hd), sdt)
        c["av"] = zeros((G, batch, W, KV, hd), sdt)
        c["apos"] = torch.full((W,), -1, dtype=torch.int32, device=device)
    else:
        raise ValueError(fam)
    return c


def cache_logical_axes(cfg) -> Dict[str, tuple]:
    """The logical axes of each ``init_cache`` entry (the reference's):
    the KV's sequence dim is "kv_seq", which the decode rule-set shards
    over "model" (flash-decode, ``layers.decode_attention_update``)."""
    fam = cfg.family
    ax: Dict[str, tuple] = {"pos": ()}
    if fam in ("dense", "moe", "vlm", "audio"):
        kv = ("layers", "batch", "kv_seq", "kv_heads", None)
        ax["k"] = ax["v"] = kv
        ax["k_scale"] = ax["v_scale"] = kv
        if fam == "audio":
            ax["ck"] = ax["cv"] = ("layers", "batch", None, "kv_heads", None)
            ax["cross_len"] = ()
    elif fam == "ssm":
        ax["tm"] = ax["cm"] = ("layers", "batch", None)
        ax["wkv"] = ("layers", "batch", "heads", None, None)
    elif fam == "hybrid":
        ax["h"] = ("layers", None, "batch", "heads", None, None)
        ax["conv"] = ("layers", None, "batch", None, "ssm_inner")
        ax["ak"] = ax["av"] = ("layers", "batch", "kv_seq", "kv_heads", None)
        ax["apos"] = ("kv_seq",)
    return ax


def quantize_kv(x):
    """x: (..., hd) -> (int8 codes, f32 scale (..., 1)): the max-abs scale
    max(amax, 1e-6) / 127, codes rounded half to even and clipped to
    +-127."""
    xf = x.to(F32)
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def write_kv(cache_k, cache_v, k_new, v_new, pos: int, k_scale=None,
             v_scale=None):
    """Write one token's k/v (B, 1, KV, hd) at ``pos`` into (B, S, KV, hd)
    caches IN PLACE, quantized when the scales are given. Returns (k, v,
    k_scale, v_scale)."""
    if k_scale is not None:
        (kq, ks), (vq, vs) = quantize_kv(k_new), quantize_kv(v_new)
        for buf, new in ((cache_k, kq), (cache_v, vq), (k_scale, ks),
                         (v_scale, vs)):
            buf[:, pos:pos + 1] = new
        return cache_k, cache_v, k_scale, v_scale
    cache_k[:, pos:pos + 1] = k_new.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v_new.to(cache_v.dtype)
    return cache_k, cache_v, None, None


def paged_cache_bytes(cfg, n_pages: int, page_size: int, dtype=None) -> int:
    itemsize = torch.empty((), dtype=dtype or KV_DTYPE).element_size()
    return (2 * cfg.n_layers * n_pages * page_size * cfg.n_kv_heads
            * cfg.head_dim * itemsize)


def dense_cache_bytes(cfg, n_slots: int, max_len: int, dtype=None) -> int:
    """Bytes a dense (L, n_slots, max_len, KV, hd) slab would take."""
    itemsize = torch.empty((), dtype=dtype or KV_DTYPE).element_size()
    return (2 * cfg.n_layers * n_slots * max_len * cfg.n_kv_heads
            * cfg.head_dim * itemsize)
