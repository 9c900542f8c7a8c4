"""SSM blocks, the counterpart of ``repro.models.ssm``: Mamba2 (SSD,
chunked) and RWKV-6 (Finch: chunked linear attention with a
data-dependent per-channel decay).

Each has a parallel chunked form for prefill (a Python loop over the
chunks where the reference scans them) and an O(1)-state recurrent step for
decode (the same function at chunk 1). Recurrent state is f32.

Every exponential is of a difference of cumulative log-decays inside one
chunk, so its argument is <= 0; the pairs a chunk masks out are set to
-inf before the exponential, never after. The causal convolution is the
reference's sum of shifted products in the activations' dtype: a cuDNN
convolution would take TF32 on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import mm_f32

F32 = torch.float32


def _chunk(x, q: int):
    """(B, S, ...) -> (nc, B, q, ...)."""
    B, S = x.shape[:2]
    return x.reshape(B, S // q, q, *x.shape[2:]).movedim(1, 0)


def _unchunk(x):
    """(nc, B, q, ...) -> (B, nc*q, ...)."""
    nc, B, q = x.shape[:3]
    return x.movedim(0, 1).reshape(B, nc * q, *x.shape[3:])


def _chunk_size(chunk: int, S: int) -> int:
    """The reference's rule: at most S, halved until it divides S."""
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    return chunk


def _promoted_cat(prev, x):
    """cat([prev, x], dim=1) in their promoted dtype (the reference's
    ``jnp.concatenate``: a bf16 state meeting f32 activations)."""
    dt = torch.promote_types(prev.dtype, x.dtype)
    return torch.cat([prev.to(dt), x.to(dt)], dim=1)


# ======================================================================== #
# Mamba2 (SSD)                                                             #
# ======================================================================== #
class Mamba2State(NamedTuple):
    h: torch.Tensor      # (B, nh, hd, N) f32 SSM state
    conv: torch.Tensor   # (B, conv_w - 1, di + 2N) conv tail


def _mamba2_split(zxbcdt, cfg):
    """(..., 2di+2N+nh) -> z (di), xBC (di+2N), dt (nh), nh."""
    di, N = cfg.d_inner, cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * N, nh], dim=-1)
    return z, xBC, dt, nh


def _causal_conv(xBC, w, prev_tail=None):
    """Depthwise causal conv over the sequence. xBC: (B, S, ch); w: (cw,
    ch); prev_tail: (B, cw-1, ch) the previous tokens' inputs, or None
    (zeros). Returns silu(conv) (B, S, ch) in xBC's dtype and the new
    tail."""
    B, S, ch = xBC.shape
    cw = w.shape[0]
    if prev_tail is None:
        prev_tail = xBC.new_zeros((B, cw - 1, ch))
    xp = _promoted_cat(prev_tail, xBC)
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(cw))
    return F.silu(out.to(F32)).to(xBC.dtype), xp[:, -(cw - 1):, :]


def mamba2_forward(x, p, cfg, state: Mamba2State = None, chunk: int = 128):
    """Parallel chunked SSD. x: (B, S, d) -> (y (B, S, d), final state)."""
    B, S, d = x.shape
    di, N, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    zxbcdt = mm_f32(x, p["in_proj"]).to(x.dtype)
    z, xBC, dt, nh = _mamba2_split(zxbcdt, cfg)
    xBC, new_tail = _causal_conv(xBC, p["conv_w"],
                                 state.conv if state is not None else None)
    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    xs = xs.reshape(B, S, nh, hd)
    A = -torch.exp(p["A_log"].to(F32))                        # (nh,)
    dt = dt.to(F32) + p["dt_bias"].to(F32)
    dt = torch.logaddexp(dt, torch.zeros_like(dt))            # softplus
    la = dt * A                              # log decay a step, <= 0
    xbar = xs.to(F32) * dt[..., None]                         # (B,S,nh,hd)

    q = _chunk_size(chunk, S)
    h = state.h if state is not None else \
        torch.zeros((B, nh, hd, N), dtype=F32, device=x.device)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ys = []
    for xb, lac, Bc, Cc in zip(_chunk(xbar, q), _chunk(la, q),
                               _chunk(Bm.to(F32), q), _chunk(Cm.to(F32), q)):
        cum = torch.cumsum(lac, dim=1)                        # (B,q,nh)
        # intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) (C_i.B_j) xbar_j
        gates = cum[:, :, None, :] - cum[:, None, :, :]       # (B,qi,qj,nh)
        gates = gates.masked_fill(~mask[None, :, :, None], float("-inf"))
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)
        w = torch.exp(gates) * cb[..., None]
        y_intra = torch.einsum("bijh,bjhe->bihe", w, xb)
        # inter-chunk: y_i += exp(cum_i) * C_i . h
        y_inter = torch.einsum("bqn,bhen,bqh->bqhe", Cc, h, torch.exp(cum))
        # h' = exp(cum_Q) h + sum_j exp(cum_Q - cum_j) xbar_j B_j
        dec_q = torch.exp(cum[:, -1:, :] - cum)
        h = (torch.exp(cum[:, -1, :])[:, :, None, None] * h
             + torch.einsum("bqh,bqhe,bqn->bhen", dec_q, xb, Bc))
        ys.append(y_intra + y_inter)
    y = _unchunk(torch.stack(ys))                             # (B,S,nh,hd)
    y = y + p["D"].to(F32)[None, None, :, None] * xs.to(F32)
    y = y.reshape(B, S, di)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = y * F.silu(z.to(F32))
    var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * (1.0 + p["norm"].to(F32))
    out = mm_f32(y.to(x.dtype), p["out_proj"])
    return out.to(x.dtype), Mamba2State(h, new_tail)


def mamba2_decode_step(x_t, p, cfg, state: Mamba2State):
    """x_t: (B, 1, d) single-token recurrent step."""
    return mamba2_forward(x_t, p, cfg, state, chunk=1)


def mamba2_init_state(cfg, batch: int, device="cpu") -> Mamba2State:
    di, N = cfg.d_inner, cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    return Mamba2State(
        h=torch.zeros((batch, nh, cfg.ssm_head_dim, N), dtype=F32,
                      device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * N),
                         dtype=torch.bfloat16, device=device))


# ======================================================================== #
# RWKV-6 (Finch)                                                           #
# ======================================================================== #
class RWKV6State(NamedTuple):
    shift_tm: torch.Tensor   # (B, d) previous token (time mix)
    shift_cm: torch.Tensor   # (B, d) previous token (channel mix)
    wkv: torch.Tensor        # (B, H, dk, dv) f32


def _token_shift(x, prev):
    """x: (B, S, d); prev: (B, d) -> shifted (B, S, d), new prev (B, d)."""
    return _promoted_cat(prev[:, None, :], x[:, :-1, :]), x[:, -1, :]


def rwkv6_time_mix(x, p, cfg, state: RWKV6State, chunk: int = 64):
    """RWKV-6 time mixing with a data-dependent decay. x: (B, S, d)."""
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    xx, new_shift = _token_shift(x, state.shift_tm)

    def mix(mu):
        return x + (xx - x) * mu

    r, k, v = (mm_f32(mix(p[mu]), p[w]).reshape(B, S, H, hd)
               for mu, w in (("mu_r", "wr"), ("mu_k", "wk"), ("mu_v", "wv")))
    g = F.silu(mm_f32(mix(p["mu_g"]), p["wg"]))
    # the data-dependent decay (the Finch contribution)
    dd = mm_f32(torch.tanh(mm_f32(mix(p["mu_w"]), p["w1"])), p["w2"])
    lw = -torch.exp(p["w0"].to(F32) + dd)           # (B,S,d) log decay < 0
    lw = lw.reshape(B, S, H, hd)
    u = p["u"].to(F32).reshape(H, hd)               # per-channel bonus

    q = _chunk_size(chunk, S)
    lower = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device),
                       diagonal=-1)
    eye = torch.eye(q, dtype=F32, device=x.device)
    wkv = state.wkv
    ys = []
    for rc, kc, vc, lwc in zip(_chunk(r, q), _chunk(k, q), _chunk(v, q),
                               _chunk(lw, q)):
        cum = torch.cumsum(lwc, dim=1)              # (B,q,H,hd) inclusive
        pw = cum - lwc                              # exclusive
        # intra: strictly lower pairs, plus the diagonal's bonus u
        gates = pw[:, :, None] - cum[:, None, :]    # (B,qi,qj,H,hd)
        gates = gates.masked_fill(~lower[None, :, :, None, None],
                                  float("-inf"))
        A = torch.einsum("bihc,bijhc,bjhc->bijh", rc, torch.exp(gates), kc)
        A = A + torch.einsum("bihc,hc,bihc->bih", rc, u, kc)[:, :, None, :] \
            * eye[None, :, :, None]
        y = torch.einsum("bijh,bjhv->bihv", A, vc)
        # inter: r_i decayed from the chunk's start against the state
        y = y + torch.einsum("bihc,bhcv->bihv", rc * torch.exp(pw), wkv)
        decay_rest = torch.exp(cum[:, -1:] - cum)
        wkv = (torch.exp(cum[:, -1])[..., None] * wkv
               + torch.einsum("bqhc,bqhv->bhcv", kc * decay_rest, vc))
        ys.append(y)
    y = _unchunk(torch.stack(ys))                   # (B,S,H,hd) f32
    # per-head group norm, then the gate and the output projection
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 64e-5)
    y = (y * p["ln_w"].to(F32).reshape(H, hd)
         + p["ln_b"].to(F32).reshape(H, hd))
    y = (y.reshape(B, S, H * hd) * g).to(x.dtype)
    out = mm_f32(y, p["wo"])
    return out.to(x.dtype), RWKV6State(new_shift, state.shift_cm, wkv)


def rwkv6_channel_mix(x, p, cfg, state: RWKV6State):
    """RWKV-6 channel mixing: sigmoid(r) * (relu(k)^2 W_v). x: (B, S, d)."""
    xx, new_shift = _token_shift(x, state.shift_cm)
    xk = x + (xx - x) * p["cmu_k"]
    xr = x + (xx - x) * p["cmu_r"]
    k = torch.square(F.relu(mm_f32(xk, p["ck"])))
    v = mm_f32(k.to(x.dtype), p["cv"])
    r = torch.sigmoid(mm_f32(xr, p["cr"]))
    return (r * v).to(x.dtype), RWKV6State(state.shift_tm, new_shift,
                                           state.wkv)


def rwkv6_init_state(cfg, batch: int, device="cpu") -> RWKV6State:
    zeros = torch.zeros((batch, cfg.d_model), dtype=torch.bfloat16,
                        device=device)
    return RWKV6State(
        shift_tm=zeros, shift_cm=zeros.clone(),
        wkv=torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                        dtype=F32, device=device))
