"""Three-term roofline on the H100, the counterpart of
``repro.analysis.roofline``:

  compute    = flops_per_device / PEAK_FLOPS              [s]
  memory     = bytes_per_device / HBM_BW                  [s]
  collective = collective_bytes_per_device / LINK_BW      [s]

The port has no compiled HLO to read: a step's counts come from
``analysis.counter``, which counts the aten contractions a step issues,
each materialised op's operand and result bytes, the collectives of
``distributed.collectives`` by kind, and each hand-written kernel's work
from ``kernel_work`` below.

The peaks are NVIDIA's H100 SXM data-sheet figures: 989 TFLOP/s of dense
bf16 on the tensor cores, 3.35 TB/s of HBM3, and 450 GB/s a direction of
NVLink (the collective term's one-link denominator).

MODEL_FLOPS (useful work): 6·N·D train, 2·N·D prefill, 2·N·B decode (N =
active parameters for MoE); the ratio MODEL_FLOPS / (counted flops x
chips) surfaces dispatch, capacity padding and recompute.

``kernel_work(name, args, kw, form)`` is the kernels' work model, one
yardstick for every bound the port prints: bytes each call must move
(every input it needs read once, every output written once) and the
operations it does. ``form="data"`` reads this call's data: the rows that
hold data, the distinct factor or weight slices they read, each row's true
rank, the pages with a valid key. ``form="shape"`` needs none: every row
active, every factor at the pool rank, every page of the table read, so a
call on the meta device (a dry run) counts the same work on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

PEAK_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
HBM_BW = 3.35e12         # B/s, H100 SXM data sheet
LINK_BW = 450e9          # B/s a direction of NVLink 4, H100 SXM data sheet

FORMS = ("data", "shape")


def model_flops(cfg, shape) -> float:
    """Useful flops of one step of ``shape`` (the reference's)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def bound_ms(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """(the least ms the card could take for ``n_bytes`` moved and
    ``n_ops`` operations, "bytes" or "operations": whichever sets it)."""
    t_bytes, t_ops = n_bytes / HBM_BW, n_ops / PEAK_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ----------------------------- kernel work ------------------------------ #
def _arg(args, kw, i: int, name: str, default=None):
    return args[i] if len(args) > i else kw.get(name, default)


def _paged(args, kw, form):
    q, k, _, bt, pos = args[:5]
    window = kw.get("window", args[5] if len(args) > 5 else 0) or 0
    B, KV, G, hd = q.shape
    ps, nb = k.shape[1], bt.shape[1]
    if form == "data":
        import torch
        kp = (torch.arange(nb, device=q.device)[:, None] * ps
              + torch.arange(ps, device=q.device)[None, :])[None]
        p = pos.long()[:, None, None]
        valid = (bt[:, :, None] >= 0) & (kp <= p) & (p >= 0)
        if window:
            valid &= kp > p - window
        pages, keys = int(valid.any(-1).sum()), int(valid.sum())
    else:       # every page of the table, every key of the window
        pages = B * nb
        keys = B * (min(nb * ps, window) if window else nb * ps)
    n_bytes = (q.numel() * q.element_size()
               + pages * ps * KV * hd * k.element_size() * 2
               + bt.numel() * 4 + pos.numel() * 4 + q.numel() * 4)
    return n_bytes, keys * KV * G * hd * 4


def _gmm(args, kw, form):
    xe, w = args[:2]
    sizes = _arg(args, kw, 2, "group_sizes")
    E, C, d_in = xe.shape
    d_out = w.shape[-1]
    if form == "data" and sizes is not None:
        n_rows, used = int(sizes.sum()), int((sizes > 0).sum())
    else:
        n_rows, used = E * C, E
    n_bytes = (n_rows * d_in * xe.element_size()
               + used * d_in * d_out * w.element_size()
               + (E * 4 if sizes is not None else 0) + E * C * d_out * 4)
    return n_bytes, 2 * n_rows * d_in * d_out


def _rows_work(x, A, B, n_act: int, row_cols: int, factor_cols: int,
               n_idx: int, n_out: int):
    """A shrink-expand: ``n_act`` rows with data contracting ``row_cols``
    rank columns in all, the distinct factor slices read at
    ``factor_cols`` columns in all, ``n_idx`` int32 indices, an f32 output
    of ``n_out`` elements."""
    d_in, d_out, el = A.shape[-2], B.shape[-1], A.element_size()
    n_bytes = (n_act * d_in * x.element_size()
               + factor_cols * (d_in + d_out) * el + n_idx * 4 + n_out * 4)
    return n_bytes, 2 * row_cols * (d_in + d_out)


def _bgmv(args, kw, form):
    x, A, B, ids = args[:4]
    T, r = x.shape[0], A.shape[-1]
    if form == "data":
        act = ids >= 0
        n_act, n_ad = int(act.sum()), len(set(ids[act].tolist()))
    else:
        n_act, n_ad = T, min(T, A.shape[0])
    return _rows_work(x, A, B, n_act, n_act * r, n_ad * r, T,
                      T * B.shape[-1])


def _bgmv_ranked(args, kw, form):
    x, A, B, ids, ranks = args[:5]
    T, N, r = x.shape[0], A.shape[0], A.shape[-1]
    if form == "shape":
        n_ad = min(T, N)
        return _rows_work(x, A, B, T, T * r, n_ad * r, T + ranks.numel(),
                          T * B.shape[-1])
    act = ids >= 0
    rows = ids[act].long().clamp(max=N - 1).tolist()
    rk = [min(max(int(c), 0), r) for c in ranks.tolist()]
    return _rows_work(x, A, B, len(rows), sum(rk[a] for a in rows),
                      sum(rk[a] for a in set(rows)), T + ranks.numel(),
                      T * B.shape[-1])


def _bgmv_expert(args, kw, form):
    x, A, B, ids, eids = args[:5]
    ranks = _arg(args, kw, 5, "ranks")
    T, r = x.shape[0], A.shape[-1]
    n_idx = (3 if ranks is not None else 2) * T
    if form == "shape":
        pairs = min(T, A.shape[0] * A.shape[1])
        return _rows_work(x, A, B, T, T * r, pairs * r, n_idx,
                          T * B.shape[-1])
    import torch
    r_mod = _arg(args, kw, 6, "r_mod", 0) or r
    act = ids >= 0
    if ranks is not None:       # factor columns each row's mask keeps
        col = torch.arange(r, device=x.device)
        cols = ((col[None, :] % r_mod) < ranks[:, None]).sum(-1)
    else:
        cols = torch.full((T,), r, device=x.device)
    pairs: Dict[Tuple[int, int], int] = {}
    for a, e, c in zip(ids[act].tolist(), eids[act].tolist(),
                       cols[act].tolist()):
        pairs[a, e] = max(pairs.get((a, e), 0), c)
    return _rows_work(x, A, B, int(act.sum()), int(cols[act].sum()),
                      sum(pairs.values()), n_idx, T * B.shape[-1])


def _segments(seg_rows, keys, seg_rank, A, B, n_idx, form, n_keys):
    """The segment kernels: ``keys`` (S,) the factor slice a segment reads
    (an adapter, or a (slot, expert) pair), -1 for a padding segment;
    ``n_keys`` the number of distinct slices the pool holds."""
    S, cap = seg_rows.shape[:2]
    r = A.shape[-1]
    n_out = S * cap * B.shape[-1]
    if form == "shape":
        return _rows_work(seg_rows, A, B, S * cap, S * cap * r,
                          min(S, n_keys) * r, n_idx, n_out)
    act = keys >= 0
    rows = ((seg_rows != 0).any(-1) & act[:, None]).sum(-1).tolist()
    rk = ([r] * S if seg_rank is None else
          [min(max(int(c), 0), r) for c in seg_rank.tolist()])
    factor: Dict[int, int] = {}
    for s, key in enumerate(keys.tolist()):
        if key >= 0:
            factor[key] = max(factor.get(key, 0), rk[s])
    return _rows_work(seg_rows, A, B, sum(rows),
                      sum(n * c for n, c in zip(rows, rk)),
                      sum(factor.values()), n_idx, n_out)


def _sgmv(args, kw, form, ranked):
    seg_rows, seg_adapter = args[:2]
    seg_rank = args[2] if ranked else None
    A, B = args[-2:]
    S = seg_rows.shape[0]
    return _segments(seg_rows, seg_adapter, seg_rank, A, B,
                     (2 if ranked else 1) * S, form, A.shape[0])


def _fused(args, kw, form, ranked):
    seg_rows, seg_slot, seg_eid = args[:3]
    seg_rank = args[3] if ranked else None
    A, B = args[-2:]
    S, (M, E) = seg_rows.shape[0], A.shape[:2]
    keys = seg_slot if form == "shape" else (
        seg_slot.long() * E + seg_eid.long()).where(seg_slot >= 0, -1)
    return _segments(seg_rows, keys, seg_rank, A, B,
                     (3 if ranked else 2) * S, form, M * E)


KERNEL_WORK = {
    "paged_attention": _paged,
    "gmm": _gmm,
    "bgmv": _bgmv,
    "bgmv_ranked": _bgmv_ranked,
    "bgmv_expert": _bgmv_expert,
    "sgmv": lambda a, k, f: _sgmv(a, k, f, False),
    "sgmv_ranked": lambda a, k, f: _sgmv(a, k, f, True),
    # the rank-bucketed dispatch computes sgmv_ranked's function
    "sgmv_rank_grouped": lambda a, k, f: _sgmv(a, k, f, True),
    "fused_sgmv": lambda a, k, f: _fused(a, k, f, False),
    "fused_sgmv_ranked": lambda a, k, f: _fused(a, k, f, True),
}


def kernel_work(name: str, args, kw=None, form: str = "data"
                ) -> Tuple[int, int]:
    """(bytes, operations) of one call of kernel entry ``name`` (an op of
    ``kernels.ops``) on ``args``/``kw``, in ``form`` "data" (this call's
    data: reads the ids, ranks and sizes on the host) or "shape" (shapes
    only: every row active at the pool rank; runs on meta tensors)."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    return KERNEL_WORK[name](tuple(args), dict(kw or {}), form)


def kernel_bound(name: str, args, kw=None, form: str = "data"
                 ) -> Tuple[float, str]:
    """``bound_ms`` of ``kernel_work``."""
    return bound_ms(*kernel_work(name, args, kw, form))


# ------------------------------- roofline -------------------------------- #
@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int]
    peak_mem_per_device: float
    model_flops: float

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Lower-bound step time: overlapped terms -> max()."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs utilization if the step ran at its roofline bound
        (MFU-at-bound): model_flops / (chips * peak * step_time)."""
        t = self.step_time
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * t)

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "peak_mem_per_device": self.peak_mem_per_device,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time": self.step_time,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze(arch: str, shape_name: str, mesh_name: str, chips: int,
            counted: Dict, peak_mem: float, cfg, shape) -> Roofline:
    """The roofline of a counted step: ``counted`` is what
    ``analysis.counter.Counter.summary`` returns (``flops``,
    ``hbm_bytes``, ``coll_bytes`` by kind, ``coll_total``), one rank's."""
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_device=float(counted["flops"]),
        bytes_per_device=float(counted["hbm_bytes"]),
        coll_bytes_per_device=float(counted["coll_total"]),
        coll_breakdown={k: int(v) for k, v in counted["coll_bytes"].items()},
        peak_mem_per_device=peak_mem,
        model_flops=model_flops(cfg, shape),
    )
