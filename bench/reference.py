"""The plain reference of the MoE decoder the cells serve: plain PyTorch
in float32 with TF32 off, written from the architecture and not from the
program (it imports nothing of ``repro_torch``).

What it computes, for each sampled request's prompt and served tokens at
once (a full causal forward, no cache, no kernels):

  x = embed[tok]
  per layer: x += Wo attn(rope(Wq n1(x)), rope(Wk n1(x)), Wv n1(x))   GQA,
             causal, softmax(q k / sqrt(hd))
             h = n2(x); p = softmax(h Wr); top-k experts by p (ties to the
             lower id), weights renormalised over the k
             x += sum_k w_k [ (silu(h Wg_e + dg) * (h Wu_e + du)) Wd_e + dd ]
  logits = n_f(x) Wlm^T over the true vocabulary

with n(x) = x / rms(x) * (1 + scale), RoPE on the two halves of each head,
and the adapter's expert deltas (dg, du: the gate and up targets on h; dd:
the down target on the activation), each scale * (v A[:, :r]) B[:r] at the
adapter's TRUE rank r, applied to a token only from the position where its
decoding starts (the last prompt token): the serving plane's prefill is
LoRA-free and its decode steps are not (the LoRA Server adds the deltas).
The plane applies no other adapter target.

``precision="fp8"`` is the control: every matrix product takes its
operands rounded to float8 e4m3 (weights per output channel, activations
per row), the step below the configured bfloat16 that a change could be
tempted to take. ``precision="bf16"`` is a witness, not a check: the same
forward with the activations held in bf16 where a bf16 serving stack
holds them (matrix operands, the residual stream, q/k/v and the cache,
the expert activation), to show what bf16 arithmetic alone reads.

Memory: the weights stay in their served bf16; each layer's matrices are
cast to f32 when used, the experts one at a time, so the reference fits
beside the weights once the program's state is freed.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

F32 = torch.float32
PRECISIONS = ("f32", "fp8", "bf16")


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale along ``dim``'s slices
    (absmax to 448), returned in f32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(F32) * s


class _Mm:
    """x (n, k) @ w (k, m) in f32, with both operands in fp8, or with
    both in bf16."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(precision)
        self.precision = precision

    def __call__(self, x, w):
        w = w.to(F32)
        if self.precision == "fp8":
            return _q8(x, -1) @ _q8(w, 0)
        if self.precision == "bf16":
            return _bf16(x) @ _bf16(w)
        return x @ w


def _bf16(t):
    return t.to(torch.bfloat16).to(F32)


def _norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.to(F32))


def _rope(x, pos, theta: float):
    """x (S, h, hd): rotate the two halves of each head by pos * freq."""
    hd = x.shape[-1]
    freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                         device=x.device) / hd))
    ang = pos.to(torch.float64)[:, None] * freq[None, :]
    cos = torch.cos(ang).to(F32)[:, None, :]
    sin = torch.sin(ang).to(F32)[:, None, :]
    a, b = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(q, k, v):
    """Causal GQA attention of one sequence: q (S, H, hd), k/v (S, KV,
    hd) -> (S, H*hd)."""
    S, H, hd = q.shape
    KV = k.shape[1]
    g = H // KV
    qg = q.reshape(S, KV, g, hd)
    s = torch.einsum("qkgd,skd->kgqs", qg, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("kgqs,skd->qkgd", p, v).reshape(S, H * hd)


def forward_hidden(W: Dict, adapters: Dict, m: Dict, seqs: Sequence[Dict],
                   precision: str = "f32", margins: Optional[List] = None
                   ) -> List[torch.Tensor]:
    """The final normed hidden states (f32) of each sequence.

    ``W``: the parameter tree; ``adapters``: {target: {"A", "B"}} of shape
    (L, N, E, d_in, r) / (L, N, E, r, d_out); ``m``: the model's sizes
    (``d_model``, ``n_heads``, ``n_kv_heads``, ``head_dim``, ``n_layers``,
    ``n_experts``, ``top_k``, ``rope_theta``, ``norm_eps``,
    ``lora_scale``); each seq: {"tokens" (S,) int64, "adapter" id,
    "rank" its true rank, "lora_from" the first position with deltas}.
    ``margins``, a list, receives each layer's router margin of every
    token: the k-th expert's probability less the next one's (how near
    the choice of experts is to a tie)."""
    mm = _Mm(precision)
    rnd = _bf16 if precision == "bf16" else (lambda t: t)
    dev = W["embed"].device
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    E, K, eps = m["n_experts"], m["top_k"], m["norm_eps"]
    toks = [torch.as_tensor(s["tokens"], device=dev) for s in seqs]
    lens = [int(t.shape[0]) for t in toks]
    x = W["embed"][torch.cat(toks)].to(F32)                  # (T, d)
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    ad = torch.cat([torch.full((n,), int(s["adapter"]), device=dev)
                    for n, s in zip(lens, seqs)])
    on = torch.cat([torch.arange(n, device=dev) >= int(s["lora_from"])
                    for n, s in zip(lens, seqs)])
    rank_of = {int(s["adapter"]): int(s["rank"]) for s in seqs}
    scale = float(m["lora_scale"])
    L = m["n_layers"]
    for l in range(L):
        lw = W["layers"]
        h = rnd(_norm(x, lw["ln1"][l], eps))
        q = rnd(mm(h, lw["attn"]["wq"][l])).reshape(-1, H, hd)
        k = rnd(mm(h, lw["attn"]["wk"][l])).reshape(-1, KV, hd)
        v = rnd(mm(h, lw["attn"]["wv"][l])).reshape(-1, KV, hd)
        q = rnd(_rope(q, pos, m["rope_theta"]))
        k = rnd(_rope(k, pos, m["rope_theta"]))
        att, o = [], 0
        for n in lens:
            att.append(_attention(q[o:o + n], k[o:o + n], v[o:o + n]))
            o += n
        x = rnd(x + rnd(mm(rnd(torch.cat(att)), lw["attn"]["wo"][l])))
        h = rnd(_norm(x, lw["ln2"][l], eps))
        probs = torch.softmax(mm(h, lw["moe"]["router"][l]), dim=-1)
        w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        if margins is not None and K < E:
            margins.append(w[:, K - 1] - w[:, K])
        w, ids = w[:, :K], ids[:, :K]
        w = w / w.sum(-1, keepdim=True)
        out = torch.zeros_like(x)
        for e in range(E):
            tok, slot = torch.nonzero(ids == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            he = h[tok]
            g = mm(he, lw["moe"]["gate"][l, e])
            u = mm(he, lw["moe"]["up"][l, e])
            lora_rows = []
            for a in torch.unique(ad[tok][on[tok]]).tolist():
                rows = torch.nonzero(on[tok] & (ad[tok] == a)).reshape(-1)
                lora_rows.append((a, rows))
                r = rank_of[a]
                for tgt, base in (("gate", g), ("up", u)):
                    A = adapters[tgt]["A"][l, a, e, :, :r]
                    B = adapters[tgt]["B"][l, a, e, :r, :]
                    base[rows] += scale * mm(mm(he[rows], A), B)
            act = rnd(torch.nn.functional.silu(g) * u)
            y = mm(act, lw["moe"]["down"][l, e])
            for a, rows in lora_rows:
                r = rank_of[a]
                A = adapters["down"]["A"][l, a, e, :, :r]
                B = adapters["down"]["B"][l, a, e, :r, :]
                y[rows] += scale * mm(mm(act[rows], A), B)
            out.index_add_(0, tok, y * w[tok, slot][:, None])
        x = rnd(x + rnd(out))
    x = rnd(_norm(x, W["final_norm"], eps))
    outs, o = [], 0
    for n in lens:
        outs.append(x[o:o + n])
        o += n
    return outs


def logits(W: Dict, m: Dict, h: torch.Tensor, precision: str = "f32",
           block: int = 256) -> torch.Tensor:
    """h (S, d) f32 -> logits (S, vocab) f32, the lm head in row blocks."""
    mm = _Mm(precision)
    head = W["lm_head"][: m["vocab_size"]].t()
    return torch.cat([mm(h[i:i + block], head)
                      for i in range(0, h.shape[0], block)])


def reference_mode():
    """Float32 matrix products without TF32, as the reference needs; a
    context that restores the previous settings."""
    class _Mode:
        def __enter__(self):
            self.prev = (torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32,
                         torch.get_float32_matmul_precision())
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
            return self

        def __exit__(self, *exc):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, prec) = self.prev
            torch.set_float32_matmul_precision(prec)
            return False

    return _Mode()
