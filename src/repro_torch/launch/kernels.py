"""The LoRA-kernel path of the port: every LoRA kernel and the grouped
expert GEMM, driven through ``kernels/ops.py`` at the width of
Qwen3-235B-A22B on three traffic sets, with the path's own invariants.

  PYTHONPATH=src python -m repro_torch.launch.kernels [--device cpu]
      [--reduced] [--seed 0]

(a) the paper's Fig. 19 LoRA kernels on the reference's settings
    (``benchmarks/bench_kernels.py``): N adapters of true rank drawn
    zipf-weighted from RANK_MIX in a prefix-zero pool of rank 64, T rows
    with zipf(1.2) adapter popularity, d_in = d_out = the hidden width,
    segments of cap rows: bgmv, bgmv_ranked, build_segments + sgmv,
    build_segments_ranked + sgmv_ranked, and sgmv_rank_grouped;
(b) the server-hook operator on the LoRA Server's pool (4 slots of true
    rank 8/16/32/32 in a rank-32 pool, every expert): a decode batch of
    tokens, each routed to top_k distinct experts, grouped into
    (slot, expert) segments; fused_sgmv_ranked on the down hook, fused_sgmv
    on the block-diagonal gate|up hook, both held against the per-row hook
    kernel bgmv_expert;
(c) the grouped expert GEMM at a decode dispatch (dropless capacity
    C = tokens * top_k): gmm for gate, up and down.

Weights and activations are drawn from a ``torch.Generator`` on the device;
adapter ids, ranks and routing from numpy seeds, as the reference draws
them. Runs on the CUDA card unless ``--device cpu`` is given, where every
op takes its plain twin.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.sgmv import gather_rows
from repro_torch.models.model import resolve_device
from repro_torch.serving.workload import zipf_popularity

ARCH = "qwen3-moe-235b-a22b"
RANK_MIX = (4, 8, 16, 64)       # mixed-rank pool buckets (zipf-weighted)
R_POOL = 64                     # (a): the pool rank, as the reference's
ZIPF_S = 1.2                    # (a): adapter popularity exponent
SLOT_RANKS = (8, 16, 32, 32)    # (b): the server's slots, pool rank 32
# Two kernels, or a kernel and its twin, that sum in different orders on
# the same bf16 inputs agree to f32 rounding: ~1e-6 at these widths.
TOL = 1e-4


def zipf_rank_mix(n_adapters: int, seed: int = 0) -> np.ndarray:
    """Per-adapter true ranks: a zipf-weighted draw over RANK_MIX (small
    ranks dominate), as ``benchmarks/bench_kernels.py`` draws them."""
    rng = np.random.default_rng(seed)
    p = zipf_popularity(len(RANK_MIX), 1.2)
    return rng.choice(np.asarray(RANK_MIX), size=n_adapters, p=p)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The path's traffic counts; widths come from the model config."""
    # (a) Fig. 19 LoRA kernels
    n_adapters: int = 512
    rows: int = 1024
    cap: int = 64
    # (b) the server-hook operator
    hook_tokens: int = 256
    hook_cap: int = 16
    # (c) grouped expert GEMM
    gmm_tokens: int = 8


FULL = Sizes()
REDUCED = Sizes(n_adapters=16, rows=64, cap=8, hook_tokens=16, hook_cap=8,
                gmm_tokens=4)


@dataclasses.dataclass(frozen=True)
class Work:
    """What one call needs on this run's data, for its bound: bytes of the
    activation rows that carry data, of the distinct factor (or weight)
    slices at the rank the call contracts, of the int32 ids and ranks, and
    of the f32 output written once; and the multiply-adds' operations."""
    x_bytes: int
    w_bytes: int
    idx_bytes: int
    out_bytes: int
    operations: int

    @property
    def bytes(self) -> int:
        return self.x_bytes + self.w_bytes + self.idx_bytes + self.out_bytes


class Case(NamedTuple):
    """One call of the path: the op's name in ``kernels.ops``, its
    arguments, and its work (None for a call that is not timed here)."""
    op: str
    args: Tuple
    work: Optional[Work]


def _lora_work(elt: int, rows: int, row_rank_sum: int, factor_rank_sum: int,
               d_in: int, d_out: int, n_idx: int, n_out: int) -> Work:
    """A shrink-expand: ``rows`` rows with data, each contracting
    ``row_rank_sum`` rank columns in all; the distinct factor slices read
    at ``factor_rank_sum`` columns in all; ``elt`` bytes an element."""
    return Work(x_bytes=rows * d_in * elt,
                w_bytes=factor_rank_sum * (d_in + d_out) * elt,
                idx_bytes=4 * n_idx, out_bytes=4 * n_out,
                operations=2 * row_rank_sum * (d_in + d_out))


def _randn(g, shape, dtype, scale: float):
    return (torch.randn(shape, generator=g, device=g.device) * scale
            ).to(dtype)


def _prefix_zero(t, ranks, axis: int, r_mod: int):
    """Zero ``t`` along ``axis`` (the rank axis) at c % r_mod >= ranks[n],
    for the leading adapter axis n; +0.0 exactly."""
    r = t.shape[axis]
    col = torch.arange(r, device=t.device) % r_mod
    keep = col[None, :] < ranks.to(t.device)[:, None]          # (N, r)
    shape = [1] * t.dim()
    shape[0], shape[axis] = keep.shape
    return torch.where(keep.reshape(shape), t, torch.zeros((), dtype=t.dtype,
                                                           device=t.device))


def _max_diff(a, b) -> float:
    return (a.float() - b.float()).abs().max().item() if a.numel() else 0.0


def _check(invariants, name: str, got: float, tol: Optional[float]):
    """tol None: bitwise (got is 1.0 when equal)."""
    ok = got == 1.0 if tol is None else got <= tol
    invariants.append({"name": name, "value": got,
                       "tol": "bitwise" if tol is None else tol, "ok": ok})


def lora_kernels(g, cfg, sz: Sizes, dtype, seed: int, cases, outputs,
                 invariants, counts):
    """(a): bgmv, bgmv_ranked, sgmv, sgmv_ranked, sgmv_rank_grouped."""
    dev = g.device
    N, T, r, d, cap = sz.n_adapters, sz.rows, R_POOL, cfg.d_model, sz.cap
    rng = np.random.default_rng(seed)
    ids_np = rng.choice(N, size=T, p=zipf_popularity(N, ZIPF_S))
    ranks_np = np.minimum(zipf_rank_mix(N, seed), r)
    ids = torch.as_tensor(ids_np, dtype=torch.int32).to(dev)
    ranks = torch.as_tensor(ranks_np, dtype=torch.int32).to(dev)
    x = _randn(g, (T, d), dtype, 1.0)
    A = _prefix_zero(_randn(g, (N, d, r), dtype, d ** -0.5), ranks, 2, r)
    B = _prefix_zero(_randn(g, (N, r, d), dtype, 0.01), ranks, 1, r)

    # every row is real (no id -1); a segment keeps at most cap rows
    per_ad = np.bincount(ids_np, minlength=N)
    used, kept_ad = per_ad > 0, np.minimum(per_ad, cap)
    n_kept, elt = int(kept_ad.sum()), x.element_size()
    pad_fac, rank_fac = int(used.sum()) * r, int(ranks_np[used].sum())
    ranked_rows = int((kept_ad * ranks_np).sum())
    seg, seg_ad, scatter = ops.build_segments(x, ids, N, cap)
    seg_r, seg_ad_r, seg_rank, scatter_r = ops.build_segments_ranked(
        x, ids, N, cap, ranks)
    cases["bgmv"] = Case("bgmv", (x, A, B, ids), _lora_work(
        elt, T, T * r, pad_fac, d, d, T, T * d))
    cases["bgmv_ranked"] = Case("bgmv_ranked", (x, A, B, ids, ranks),
                                _lora_work(elt, T, int(ranks_np[ids_np].sum()),
                                           rank_fac, d, d, T + N, T * d))
    cases["sgmv"] = Case("sgmv", (seg, seg_ad, A, B), _lora_work(
        elt, n_kept, n_kept * r, pad_fac, d, d, N, N * cap * d))
    ranked_work = _lora_work(elt, n_kept, ranked_rows, rank_fac, d, d, 2 * N,
                             N * cap * d)
    for name in ("sgmv_ranked", "sgmv_rank_grouped"):
        cases[name] = Case(name, (seg_r, seg_ad_r, seg_rank, A, B),
                           ranked_work)
    for name in ("bgmv", "bgmv_ranked", "sgmv", "sgmv_ranked",
                 "sgmv_rank_grouped"):
        outputs[name] = getattr(ops, cases[name].op)(*cases[name].args)

    kept = scatter.long() < N * cap
    act = seg_ad_r >= 0
    distinct = np.unique(ids_np)
    counts.update(
        adapters=N, rows=T, distinct_adapters=int(distinct.size),
        largest_adapter_rows=int(np.bincount(ids_np).max()),
        rows_kept=int(kept.sum()), rows_dropped=int((~kept).sum()),
        mean_row_rank=float(ranks_np[ids_np].mean()),
        ranks_present=sorted(set(ranks_np[distinct].tolist())),
        active_segments=int(act.sum()),
        rank_buckets=len(set(seg_rank[act].tolist())))
    y_bg, y_sg = outputs["bgmv"], outputs["sgmv"]
    _check(invariants, "bgmv_ranked == bgmv (prefix-zero pool)",
           float(torch.equal(outputs["bgmv_ranked"], y_bg)), None)
    rows_sg = gather_rows(y_sg, scatter)
    _check(invariants, "sgmv_ranked == sgmv, row by row through scatter",
           float(torch.equal(gather_rows(outputs["sgmv_ranked"], scatter_r),
                             rows_sg)), None)
    _check(invariants, "sgmv == bgmv on every kept row",
           _max_diff(rows_sg[kept], y_bg[kept]), TOL)
    _check(invariants, "sgmv_rank_grouped == sgmv_ranked",
           _max_diff(outputs["sgmv_rank_grouped"], outputs["sgmv_ranked"]),
           TOL)
    counts["rank_grouped_bitwise"] = torch.equal(
        outputs["sgmv_rank_grouped"], outputs["sgmv_ranked"])


def hook_operator(g, cfg, sz: Sizes, dtype, seed: int, cases, outputs,
                  invariants, counts):
    """(b): fused_sgmv_ranked (down), fused_sgmv (gate|up), bgmv_expert."""
    dev = g.device
    M, E, K = len(SLOT_RANKS), cfg.n_experts, cfg.top_k
    r, d, ff, cap = cfg.lora_rank, cfg.d_model, cfg.d_ff, sz.hook_cap
    slot_ranks = torch.tensor(SLOT_RANKS, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(seed + 1)
    tok_slot = rng.integers(0, M, size=sz.hook_tokens)
    experts = np.argsort(rng.random((sz.hook_tokens, E)), axis=1)[:, :K]
    row_slot_np = np.repeat(tok_slot, K)
    row_eid_np = experts.reshape(-1)
    row_slot = torch.as_tensor(row_slot_np, dtype=torch.int32).to(dev)
    row_eid = torch.as_tensor(row_eid_np, dtype=torch.int32).to(dev)
    row_rank = slot_ranks[row_slot.long()]
    key = row_slot * E + row_eid
    n_rows = key.shape[0]

    x_dn = _randn(g, (n_rows, ff), dtype, 1.0)
    A_dn = _prefix_zero(_randn(g, (M, E, ff, r), dtype, ff ** -0.5),
                        slot_ranks, 3, r)
    B_dn = _prefix_zero(_randn(g, (M, E, r, d), dtype, 0.01), slot_ranks,
                        2, r)
    x_up = _randn(g, (n_rows, d), dtype, 1.0)
    A_up = _prefix_zero(_randn(g, (M, E, d, 2 * r), dtype, d ** -0.5),
                        slot_ranks, 3, r)
    # block-diagonal gate|up expand: gate's r rows feed the first ff
    # columns, up's the last ff
    B_up = torch.zeros((M, E, 2 * r, 2 * ff), dtype=dtype, device=dev)
    B_up[:, :, :r, :ff] = _randn(g, (M, E, r, ff), dtype, 0.01)
    B_up[:, :, r:, ff:] = _randn(g, (M, E, r, ff), dtype, 0.01)
    B_up = _prefix_zero(B_up, slot_ranks, 2, r)

    seg_dn, seg_key, scatter = ops.build_segments(x_dn, key, M * E, cap)
    seg_up = ops.build_segments(x_up, key, M * E, cap)[0]
    act = seg_key >= 0
    seg_slot = torch.where(act, seg_key // E, -1).to(torch.int32)
    seg_eid = (seg_key.clamp(min=0) % E).to(torch.int32)
    seg_rank = torch.where(act, slot_ranks[seg_slot.long().clamp(min=0)],
                           0).to(torch.int32)
    # segment s is (slot s // E, expert s % E); it keeps at most cap rows
    S = M * E
    per_seg = np.bincount(row_slot_np * E + row_eid_np, minlength=S)
    used, kept_seg = per_seg > 0, np.minimum(per_seg, cap)
    n_kept, elt = int(kept_seg.sum()), x_dn.element_size()
    seg_rank_np = np.asarray(SLOT_RANKS)[np.arange(S) // E]
    cases["fused_sgmv_ranked"] = Case(
        "fused_sgmv_ranked", (seg_dn, seg_slot, seg_eid, seg_rank, A_dn,
                              B_dn),
        _lora_work(elt, n_kept, int((kept_seg * seg_rank_np).sum()),
                   int(seg_rank_np[used].sum()), ff, d, 3 * S, S * cap * d))
    cases["fused_sgmv_down"] = Case(
        "fused_sgmv", (seg_dn, seg_slot, seg_eid, A_dn, B_dn),
        _lora_work(elt, n_kept, n_kept * r, int(used.sum()) * r, ff, d,
                   2 * S, S * cap * d))
    cases["fused_sgmv"] = Case(
        "fused_sgmv", (seg_up, seg_slot, seg_eid, A_up, B_up),
        _lora_work(elt, n_kept, n_kept * 2 * r, int(used.sum()) * 2 * r, d,
                   2 * ff, 2 * S, S * cap * 2 * ff))
    cases["bgmv_expert_down"] = Case("bgmv_expert", (
        x_dn, A_dn, B_dn, row_slot, row_eid, row_rank, r), None)
    cases["bgmv_expert_up"] = Case("bgmv_expert", (
        x_up, A_up, B_up, row_slot, row_eid, row_rank, r), None)
    for name in ("fused_sgmv_ranked", "fused_sgmv_down", "fused_sgmv",
                 "bgmv_expert_down", "bgmv_expert_up"):
        outputs[name] = getattr(ops, cases[name].op)(*cases[name].args)

    kept = scatter.long() < M * E * cap
    counts.update(hook_rows=n_rows, hook_segments=M * E,
                  hook_active_segments=int(act.sum()),
                  hook_max_rows_per_segment=int(per_seg.max()),
                  hook_rows_dropped=int((~kept).sum()))
    _check(invariants, "fused_sgmv_ranked == fused_sgmv (down hook, "
           "prefix-zero pool)", float(torch.equal(
               outputs["fused_sgmv_ranked"], outputs["fused_sgmv_down"])),
           None)
    _check(invariants, "fused_sgmv_ranked == bgmv_expert (ranks, r_mod = r) "
           "on every kept row", _max_diff(
               gather_rows(outputs["fused_sgmv_ranked"], scatter)[kept],
               outputs["bgmv_expert_down"][kept]), TOL)
    _check(invariants, "fused_sgmv (gate|up) == bgmv_expert (ranks, "
           "col % r < rank) on every kept row", _max_diff(
               gather_rows(outputs["fused_sgmv"], scatter)[kept],
               outputs["bgmv_expert_up"][kept]), TOL)


def grouped_gemm(g, cfg, sz: Sizes, dtype, seed: int, cases, outputs,
                 invariants, counts):
    """(c): gmm for the gate, up and down expert GEMMs of one decode
    dispatch, each against the zero-padded batched product."""
    dev = g.device
    E, K, d, ff, T = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff, \
        sz.gmm_tokens
    C = T * K                        # dropless decode capacity
    rng = np.random.default_rng(seed + 2)
    experts = np.argsort(rng.random((T, E)), axis=1)[:, :K].reshape(-1)
    tok = np.repeat(np.arange(T), K)
    gs_np = np.bincount(experts, minlength=E)
    pos = np.zeros_like(experts)
    seen = np.zeros(E, np.int64)
    for i, e in enumerate(experts):   # each expert's rows in token order
        pos[i], seen[e] = seen[e], seen[e] + 1
    x_tok = _randn(g, (T, d), dtype, 1.0)
    xe = torch.zeros((E, C, d), dtype=dtype, device=dev)
    xe[torch.as_tensor(experts).to(dev), torch.as_tensor(pos).to(dev)] = \
        x_tok[torch.as_tensor(tok).to(dev)]
    gs = torch.as_tensor(gs_np, dtype=torch.int32).to(dev)
    w_gate = _randn(g, (E, d, ff), dtype, d ** -0.5)
    w_up = _randn(g, (E, d, ff), dtype, d ** -0.5)
    w_down = _randn(g, (E, ff, d), dtype, ff ** -0.5)

    n_rows, n_used, elt = int(gs_np.sum()), int((gs_np > 0).sum()), \
        x_tok.element_size()

    def work(d_in: int, d_out: int) -> Work:
        """The rows of the used experts and their weights, read once."""
        return Work(x_bytes=n_rows * d_in * elt,
                    w_bytes=n_used * d_in * d_out * elt, idx_bytes=4 * E,
                    out_bytes=4 * E * C * d_out,
                    operations=2 * n_rows * d_in * d_out)

    cases["gmm_gate"] = Case("gmm", (xe, w_gate, gs), work(d, ff))
    cases["gmm_up"] = Case("gmm", (xe, w_up, gs), work(d, ff))
    outputs["gmm_gate"] = ops.gmm(xe, w_gate, gs)
    outputs["gmm_up"] = ops.gmm(xe, w_up, gs)
    h = (torch.nn.functional.silu(outputs["gmm_gate"])
         * outputs["gmm_up"]).to(dtype)
    cases["gmm_down"] = Case("gmm", (h, w_down, gs), work(ff, d))
    outputs["gmm_down"] = ops.gmm(h, w_down, gs)

    rows = torch.arange(C, device=dev)[None, :] < gs.long()[:, None]
    for name in ("gmm_gate", "gmm_up", "gmm_down"):
        a, w, _ = cases[name].args
        _check(invariants, f"{name} == the zero-padded batched product",
               _max_diff(outputs[name], ref.gmm_ref(a, w)), TOL)
        _check(invariants, f"{name}: rows past group_sizes are exact 0",
               float(bool(torch.all(outputs[name][~rows] == 0))), None)
    counts.update(gmm_experts=E, gmm_capacity=C,
                  gmm_experts_used=n_used,
                  gmm_rows=n_rows,
                  gmm_max_group=int(gs_np.max()))


def expected_launches(counts: Dict) -> Dict[str, int]:
    """Kernel launches of one run of the path on the card."""
    return {"bgmv": 1, "bgmv_ranked": 1,
            "sgmv": 1 + counts["rank_buckets"], "sgmv_ranked": 1,
            "fused_sgmv": 2, "fused_sgmv_ranked": 1, "bgmv_expert": 2,
            "gmm": 3}


def run(device=None, reduced: bool = False, seed: int = 0) -> Dict:
    """Drive the path once. Returns ``cases`` (name -> ``Case``: op name in
    ``kernels.ops``, its arguments, its ``Work``), ``outputs`` (name ->
    result),
    ``counts`` of the traffic, ``invariants`` (each with its value,
    tolerance and verdict) and ``expected_launches`` on the card."""
    dev = resolve_device(device)
    dtype = torch.bfloat16
    cfg = get_config(ARCH)
    cfg = cfg.reduced() if reduced else cfg
    sz = REDUCED if reduced else FULL
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    cases, outputs, invariants, counts = {}, {}, [], {}
    for part in (lora_kernels, hook_operator, grouped_gemm):
        part(g, cfg, sz, dtype, seed, cases, outputs, invariants, counts)
    return {"config": cfg.name, "device": str(dev), "sizes":
            dataclasses.asdict(sz), "cases": cases, "outputs": outputs,
            "counts": counts, "invariants": invariants,
            "expected_launches": expected_launches(counts)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="small counts and widths (CPU runs)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    res = run(args.device, reduced=args.reduced, seed=args.seed)
    print(json.dumps({"config": res["config"], "device": res["device"],
                      "counts": res["counts"],
                      "expected_launches": res["expected_launches"]}))
    for inv in res["invariants"]:
        print(json.dumps(inv))
    bad = [inv["name"] for inv in res["invariants"] if not inv["ok"]]
    if bad:
        print(f"invariants failed: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
