"""Token-choice top-k MoE with static-capacity sort-based dispatch, the
counterpart of ``repro.models.moe``, with the coupled plane's expert LoRA.

Two plans, as the reference's:
  - local (no rules active): every expert on this device;
  - sharded (``moe_block`` under a ``ShardingRules`` over a
    ``ProcessMesh``, the plan from ``resolve_moe_plan``): each process
    holds its tokens and its shard of the expert weights in the
    reference's at-rest layout, taken to the plan's at use: experts split
    over ``ep_axis`` (tokens exchanged by a tiled all-to-all there and
    back), the expert hidden dim over ``ff_axis`` at compute time (summed
    after the down GEMM) or over ``fsdp_axis`` at rest (gathered for the
    layer); the decode plan gathers the few tokens instead
    (``_decode_allgather_moe``). Experts run through ``ops.gmm`` and the
    expert LoRA through ``ops.bgmv_expert`` on either plan.

Routing reproduces the reference's orders exactly: ``jax.lax.top_k`` keeps
the lower expert id first among equal probabilities (a stable descending
sort here), and dispatch groups (token, k) pairs by a stable argsort.
The combine gathers each token's K expert outputs and sums them in
ascending slot order, the order of the reference's scatter-add, with no
float atomics, so two runs on the card give the same tokens.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

import dataclasses
from typing import Optional

from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import active_rules
from repro_torch.kernels import ops
from repro_torch.models.layers import gelu, mm_f32
from repro_torch.models.model import EXPERT_WEIGHTS, use_layout

F32 = torch.float32


def route(x_flat, router_w, n_experts: int, top_k: int):
    """x_flat: (T, d) -> (ids (T, K) int32, weights (T, K) f32)."""
    logits = mm_f32(x_flat, router_w)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :top_k], ids[:, :top_k]
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return ids.to(torch.int32), weights


def capacity(n_tokens: int, top_k: int, n_experts: int, cf: float,
             dropless: bool = False) -> int:
    """Static per-expert slot count; ``dropless``: every pair could land on
    one expert. Rounded up to a multiple of 4, at least 4."""
    if dropless:
        c = n_tokens * top_k
    else:
        c = int(cf * n_tokens * top_k / n_experts) + 1
    return max(4, -(-c // 4) * 4)


def local_dispatch(x_flat, ids, C: int, n_experts: int):
    """Group tokens by expert into an (E, C, d) buffer, overflow dropped.

    Returns (xe (E, C, d), slot_tok (E*C,) token per slot with T = empty,
    pair_slot (T*K,) slot of each (token, k) pair with E*C = dropped)."""
    return dispatch(x_flat, ids, C, n_experts)[:3]


def dispatch(x_flat, ids, C: int, n_experts: int):
    """``local_dispatch`` and, fourth, the group sizes (E,) int32 =
    min(tokens routed to e, C), on the device: expert e's rows sit at
    0..group_sizes[e]-1 and every other row is the zero pad row, so
    ``ops.gmm`` may skip them (its rows past group_sizes are exact 0)."""
    T, d = x_flat.shape
    K = ids.shape[1]
    dev = x_flat.device
    flat_ids = ids.reshape(-1).long()
    sort_idx = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[sort_idx]
    counts = torch.zeros(n_experts, dtype=torch.long, device=dev)
    counts.scatter_add_(0, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * K, device=dev) - starts[sorted_ids]
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_ids * C + pos_in_e, n_experts * C)
    pair_slot = torch.empty_like(slot)
    pair_slot[sort_idx] = slot
    # one extra sink row takes the dropped pairs' writes, then is cut off
    slot_tok = torch.full((n_experts * C + 1,), T, dtype=torch.long,
                          device=dev)
    slot_tok[slot] = torch.where(keep, sort_idx // K, T)
    slot_tok = slot_tok[:-1]
    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))], dim=0)
    xe = x_pad[slot_tok].reshape(n_experts, C, d)
    return xe, slot_tok, pair_slot, counts.clamp(max=C).to(torch.int32)


def combine(y_slots, pair_slot, wts):
    """Router-weighted sum of each token's expert outputs.

    y_slots: (E*C, d) expert outputs per slot; pair_slot: (T*K,) from
    ``local_dispatch``; wts: (T, K). -> (T, d) f32, each token's terms
    added in ascending slot order (dropped pairs add zero)."""
    T, K = wts.shape
    d = y_slots.shape[1]
    y_pad = torch.cat([y_slots.to(F32), y_slots.new_zeros((1, d), dtype=F32)])
    slots, order = torch.sort(pair_slot.reshape(T, K), dim=1, stable=True)
    w = wts.gather(1, order)
    out = torch.zeros((T, d), dtype=F32, device=y_slots.device)
    for k in range(K):
        out = out + y_pad[slots[:, k]] * w[:, k:k + 1]
    return out


class ExpertBlocks:
    """An expert weight cut into contiguous blocks of experts, each on its
    device (``distributed.steps.shard_serve_params``); the expert dim is
    the third from last. Indexing picks a layer of every block, as
    ``model.layer_params`` does on a stacked weight. Blocks on another
    device than the first share one ``Remote``."""

    def __init__(self, blocks, remote=None):
        self.blocks = list(blocks)
        self.remote = remote

    @classmethod
    def cut(cls, w, devices, remote=None) -> "ExpertBlocks":
        """``w`` cut into ``len(devices)`` equal expert blocks, block i on
        ``devices[i]``: a view where that is ``w``'s device, else a copy
        (whose calls go through ``remote``, a new one if None)."""
        blocks = [b.to(dv) for b, dv in zip(
            torch.chunk(w, len(devices), dim=-3), devices)]
        if all(b.device == w.device for b in blocks):
            remote = None
        elif remote is None:
            remote = Remote()
        return cls(blocks, remote)

    def __getitem__(self, l) -> "ExpertBlocks":
        return ExpertBlocks((b[l] for b in self.blocks), self.remote)

    @property
    def shape(self):
        b = self.blocks[0]
        return b.shape[:-3] + (sum(x.shape[-3] for x in self.blocks),) \
            + b.shape[-2:]

    @property
    def dtype(self):
        return self.blocks[0].dtype


class Remote:
    """What the blocks on other cards need: a side stream a card, and a
    staging buffer a (card, role, shape, dtype), made at the first call of
    a shape and kept. A CUDA graph capture of the step then allocates
    nothing on those cards (their allocators take no part in it), and the
    buffers it recorded outlive it."""

    def __init__(self):
        self._streams = {}
        self._buffers = {}

    def stream(self, dev):
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        return self._streams[dev]

    def buffer(self, dev, role, shape, dtype):
        key = (dev, role, tuple(shape), dtype)
        if key not in self._buffers:
            self._buffers[key] = torch.empty(shape, dtype=dtype, device=dev)
        return self._buffers[key]


def expert_gmm(xe, w, group_sizes=None):
    """``ops.gmm(xe, w, group_sizes)``; on an ``ExpertBlocks`` one
    ``ops.gmm`` a block into its experts' slice of one f32 output on
    ``xe``'s device. A block on another card runs on that card's side
    stream, joined to the caller's by events: its rows and group sizes
    are copied into staging buffers there, its output copied back. The
    far blocks start first, so they overlap the near ones. ``gmm`` sums
    each (expert, column tile, row group) in one fixed order, so an
    expert's output does not depend on the experts beside it: the bits
    are those of one launch over all experts."""
    if not isinstance(w, ExpertBlocks):
        return ops.gmm(xe, w, group_sizes)
    E, C, _ = xe.shape
    home = xe.device
    out = torch.empty((E, C, w.shape[-1]), dtype=F32, device=home)
    spans, e0 = [], 0
    for wb in w.blocks:
        spans.append((e0, e0 + wb.shape[0], wb))
        e0 += wb.shape[0]
    far = [sp for sp in spans if sp[2].device != home]
    staged = [_far_gmm(xe, group_sizes, out, sp, w.remote) for sp in far]
    for e0, e1, wb in spans:
        if wb.device == home:
            ops.gmm(xe[e0:e1], wb, None if group_sizes is None
                    else group_sizes[e0:e1], out=out[e0:e1])
    for (e0, e1, wb), ob in zip(far, staged):
        with torch.cuda.device(wb.device), \
                torch.cuda.stream(w.remote.stream(wb.device)):
            out[e0:e1].copy_(ob)    # on the side stream; the caller's waits
    return out


def _far_gmm(xe, group_sizes, out, span, remote):
    """Start block ``span`` = (e0, e1, weight) on its card: the side stream
    joins the caller's, the rows (and group sizes) are copied into staging
    buffers there, and ``gmm`` writes a staged output, which is returned
    (``expert_gmm`` copies it back)."""
    e0, e1, wb = span
    dev = wb.device
    side = remote.stream(dev)
    go = torch.cuda.Event()
    go.record(torch.cuda.current_stream(xe.device))
    side.wait_event(go)
    with torch.cuda.device(dev), torch.cuda.stream(side):
        # one set a block: two blocks on one card hold their outputs at once
        xb = remote.buffer(dev, ("rows", e0), (e1 - e0,) + xe.shape[1:],
                           xe.dtype)
        xb.copy_(xe[e0:e1])
        gb = None
        if group_sizes is not None:
            gb = remote.buffer(dev, ("sizes", e0), (e1 - e0,),
                               group_sizes.dtype)
            gb.copy_(group_sizes[e0:e1])
        ob = remote.buffer(dev, ("out", e0), out[e0:e1].shape, F32)
        ops.gmm(xb, wb, gb, out=ob)
    return ob


def expert_ffn(xe, wg, wu, wd, lora=None, row_adapter=None,
               lora_scale: float = 1.0, group_sizes=None,
               expert_offset: int = 0):
    """Expert FFN, gated (SwiGLU) or, with ``wg`` None, GELU. xe: (E, C, d);
    wg/wu: (E, d, f); wd: (E, f, d), tensors or ``ExpertBlocks`` ->
    (E, C, d) f32. The base GEMMs run through ``expert_gmm``; with
    ``group_sizes`` (E,) int32 (``dispatch``) it skips each expert's rows
    at or past its group size, which are pad rows (their output is 0, as
    the reference's einsum over the zero rows gives).

    With ``lora`` holding expert-specific adapter factors ({gate/up/down:
    {A (N, E_total, d_in, r), B (N, E_total, r, d_out)}}, the coupled
    plane), each dispatch row's delta x A[a, e] B[a, e] * lora_scale is
    added at the paper's two hook points: to g and u in f32 before silu,
    and to the down output. One ``ops.bgmv_expert`` launch per target.
    ``row_adapter``: (E*C,) int32 adapter id per dispatch row, -1 =
    inactive. ``expert_offset``: the global id of local expert 0 (an
    expert-parallel shard), which picks the rows' adapter experts."""
    E, C, _ = xe.shape
    if lora is not None:
        row_e = expert_offset + torch.arange(
            E * C, dtype=torch.int32, device=xe.device) // C

    def dl(name, rows_in):
        if lora is None or name not in lora:
            return None
        return ops.bgmv_expert(
            rows_in.reshape(E * C, -1), lora[name]["A"], lora[name]["B"],
            row_adapter, row_e).reshape(E, C, -1) * lora_scale

    g = None
    if wg is not None:
        g = expert_gmm(xe, wg, group_sizes)
        dg = dl("gate", xe)
        if dg is not None:
            g = g + dg
    u = expert_gmm(xe, wu, group_sizes)
    du = dl("up", xe)
    if du is not None:
        u = u + du
    h = (F.silu(g) * u if wg is not None else gelu(u)).to(xe.dtype)
    y = expert_gmm(h, wd, group_sizes)
    dd = dl("down", h)
    if dd is not None:
        y = y + dd
    return y


# ------------------------------- plans ---------------------------------- #
@dataclasses.dataclass(frozen=True)
class MoEPlan:
    ep_axis: Optional[str]      # axis sharding experts (must shard tokens)
    ff_axis: Optional[str]      # axis sharding ff at compute (psum after)
    fsdp_axis: Optional[str]    # axis sharding ff at rest (gathered a layer)
    token_batch_axes: tuple     # mesh axes sharding the token batch dim
    token_seq_axis: Optional[str]


def resolve_moe_plan(cfg, batch: int, n_tokens_seq: int,
                     kind: str) -> Optional[MoEPlan]:
    """The reference's plan from the active rules (None without), for
    activations of GLOBAL batch ``batch`` and sequence ``n_tokens_seq``:
    ``ep_axis`` must shard tokens (the exchange moves them), ``ff_axis``
    must not (its sum would mix tokens), and an at-rest ff axis that shards
    tokens becomes ``fsdp_axis`` (gathered before the layer)."""
    rules = active_rules()
    if rules is None:
        return None

    def ax(name, size=None):
        r = rules._resolve(name, size)
        if r is None:
            return None
        return r if isinstance(r, str) else r[0]

    batch_axes = rules.spec(["batch"], [batch])[0]
    if batch_axes is None:
        batch_axes = ()
    elif isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    batch_axes = tuple(batch_axes)
    seq_axis = ax("seq", n_tokens_seq) if kind != "decode" else None
    token_axes = set(batch_axes) | ({seq_axis} if seq_axis else set())

    ep = ax("experts", cfg.n_experts)
    if ep is not None and ep not in token_axes:
        ep = None
    ff_rest = ax("moe_ff", cfg.d_ff)
    if ep is not None:
        if ff_rest is None:
            return MoEPlan(ep, None, None, batch_axes, seq_axis)
        if ff_rest in token_axes:
            return MoEPlan(ep, None, ff_rest, batch_axes, seq_axis)
        return MoEPlan(ep, ff_rest, None, batch_axes, seq_axis)
    # experts not shardable: replicated; ff sharded at compute on an axis
    # that does not shard the batch, gathering the sequence across it
    ff_axis = ff_rest if (ff_rest and ff_rest not in batch_axes) else None
    if ff_axis is None:
        cand = ax("mlp", cfg.d_ff)
        ff_axis = cand if (cand and cand not in batch_axes) else None
    token_seq = None if (seq_axis is not None and seq_axis == ff_axis) \
        else seq_axis
    return MoEPlan(None, ff_axis, None, batch_axes, token_seq)


def weight_specs(plan: MoEPlan):
    """The specs of a layer's (gate/up, down) expert weights under
    ``plan``, (E, d, ff) and (E, ff, d): experts over ``ep_axis``, the
    hidden dim over ``ff_axis`` or, at rest, ``fsdp_axis``."""
    ff = plan.ff_axis or plan.fsdp_axis
    return (plan.ep_axis, None, ff), (plan.ep_axis, ff, None)


# ------------------------------ the block -------------------------------- #
def moe_block(x, params, cfg, kind: str = "train", lora=None, ids_tok=None,
              lora_scale: float = 1.0):
    """x: (B, S, d) -> (B, S, d). params: router (d, E), gate/up (E, d, f),
    down (E, f, d). ``lora``: a layer's adapter factors (its gate/up/down
    are used; the coupled plane); ``ids_tok``: (B*S,) int32 adapter id per
    token.

    Without rules, the reference's local plan, dropless when T*K <= 4096
    as there, whatever the ``kind``. Under rules x and ``ids_tok`` are
    this process's tokens and the gate/up/down its shards of the expert
    weights in the at-rest layout (``model.param_shardings``; taken to the
    plan's ``weight_specs`` at use), the router and the adapters whole;
    the plan is resolved for the global token shape."""
    B, S, d = x.shape
    rules = active_rules()
    if rules is not None:
        bax, sax = rules.token_layout(B, S if kind != "decode" else None)
        plan = resolve_moe_plan(cfg, B * rules.size(bax),
                                S * rules.size(sax), kind)
        return _moe_sharded(x, params, cfg, plan, kind, bax + sax, sax,
                            lora, ids_tok, lora_scale)
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    ids, wts = route(xf, params["router"], cfg.n_experts, cfg.top_k)
    C = capacity(T, cfg.top_k, cfg.n_experts, cfg.capacity_factor,
                 dropless=(T * cfg.top_k <= 4096))
    y = _dispatch_compute_combine(xf, ids, wts, params.get("gate"),
                                  params["up"], params["down"], cfg, C,
                                  lora=lora, token_ads=ids_tok,
                                  lora_scale=lora_scale)
    return y.reshape(B, S, d).to(x.dtype)


def _dispatch_compute_combine(xf, ids, wts, wg, wu, wd, cfg, C, lora=None,
                              token_ads=None, lora_scale=1.0, mesh=None,
                              ep_axis=None, ff_axis=None):
    """Dispatch -> (exchange) -> expert FFN -> (exchange) -> combine, the
    reference's shared core. A dispatch row takes its token's adapter, or
    -1 when the row is empty (the reference's ``row_adapter`` rule).

    With ``ep_axis`` the (E, C, d) rows go to their experts' owners by a
    tiled all-to-all, (E/ep, ep*C, d) arrive, and the outputs come back
    the same way; with ``ff_axis`` the experts' partial outputs are summed
    over it. -> (T, d) f32."""
    T, d = xf.shape
    xe, slot_tok, pair_slot, sizes = dispatch(xf, ids, C, cfg.n_experts)
    row_adapter = None
    if lora is not None and token_ads is not None:
        row_adapter = torch.where(slot_tok < T,
                                  token_ads[slot_tok.clamp(max=T - 1)],
                                  -1).to(torch.int32)
    offset = 0
    if ep_axis is not None and mesh.get_group(ep_axis) is not None:
        g = mesh.get_group(ep_axis)
        xe = col.all_to_all(xe, g, 0, 1)
        if row_adapter is not None:
            row_adapter = col.all_to_all(
                row_adapter.reshape(cfg.n_experts, C), g, 0, 1).reshape(-1)
        offset = mesh.coord(ep_axis) * xe.shape[0]
        sizes = None       # the rows of a local expert are not a prefix now
    if ff_axis is not None:
        xe = col.sum_grad(xe, mesh.get_group(ff_axis))
    y = expert_ffn(xe, wg, wu, wd, lora=lora, row_adapter=row_adapter,
                   lora_scale=lora_scale, group_sizes=sizes,
                   expert_offset=offset)
    if ff_axis is not None:
        y = col.psum(y, mesh.get_group(ff_axis))
    if ep_axis is not None:
        y = col.all_to_all(y, mesh.get_group(ep_axis), 1, 0)
    return combine(y.reshape(-1, d), pair_slot, wts)


def _moe_sharded(x, params, cfg, plan: MoEPlan, kind: str, token_axes,
                 seq_axes, lora=None, ids_tok=None, lora_scale=1.0):
    """The reference's ``shard_map`` body on this process's tokens x
    (B_l, S_l, d), sharded over ``token_axes``, the sequence over
    ``seq_axes``. The expert weights are taken from their rest layout to
    the plan's (``model.use_layout``). A plan that needs whole sequences
    (its ff axis is the sequence's) gathers them first and
    reduce-scatters the experts' partial sums back."""
    rules = active_rules()
    mesh = rules.mesh
    d, E = x.shape[-1], cfg.n_experts
    ep, ffa = plan.ep_axis, plan.ff_axis
    layout = use_layout(cfg, rules, "layers", experts=(ep, ffa))
    w = {name: layout[("moe", name)].take(params[name], mesh, token_axes,
                                          f"moe/{name}")
         for name in EXPERT_WEIGHTS if params.get(name) is not None}
    wu, wd, wg = w["up"], w["down"], w.get("gate")
    gather_seq = bool(seq_axes) and plan.token_seq_axis is None
    if gather_seq:
        gs = mesh.get_group(seq_axes)
        x = col.all_gather(x, gs, 1)
        if ids_tok is not None:
            ids_tok = col.all_gather(ids_tok.reshape(x.shape[0], -1), gs,
                                     1).reshape(-1)
    if ffa and lora and mesh.size(ffa) > 1:     # this d_ff shard's slices
        lora = _ff_slice(lora, mesh.size(ffa), mesh.coord(ffa))
    Bl, Sl, _ = x.shape
    xf = x.reshape(-1, d)
    if kind == "decode" and ep is not None:
        y = _decode_allgather_moe(xf, params["router"], wg, wu, wd, cfg,
                                  mesh, ep, ffa, lora, ids_tok, lora_scale)
        return y.reshape(Bl, Sl, d).to(x.dtype)
    T = xf.shape[0]
    ids, wts = route(xf, params["router"], E, cfg.top_k)
    C = capacity(T, cfg.top_k, E, cfg.capacity_factor,
                 dropless=(kind == "decode"))
    y = _dispatch_compute_combine(
        xf, ids, wts, wg, wu, wd, cfg, C, lora=lora, token_ads=ids_tok,
        lora_scale=lora_scale, mesh=mesh, ep_axis=ep,
        ff_axis=None if gather_seq else ffa)
    y = y.reshape(Bl, Sl, d)
    if gather_seq:             # the sum over ff and the own rows at once
        y = col.reduce_scatter(y, mesh.get_group(seq_axes), 1)
    return y.to(x.dtype)


def _ff_slice(lora, n: int, c: int):
    """The expert adapters on the c-th of n d_ff shards: gate/up's B
    columns and down's A rows of that shard (down's delta is then a
    partial sum over d_ff, summed with the down GEMM's)."""
    out = {k: dict(v) for k, v in lora.items()}
    for name, f, dim in (("gate", "B", -1), ("up", "B", -1),
                         ("down", "A", -2)):
        if name in out:
            w = out[name][f]
            k = w.shape[dim] // n
            out[name][f] = w.narrow(dim, c * k, k).contiguous()
    return out


def _decode_allgather_moe(xf, rw, wg, wu, wd, cfg, mesh, ep_axis, ff_axis,
                          lora, token_ads, lora_scale):
    """The decode plan (no gradient): gather the few tokens across the
    expert axis, run this rank's experts on all of them (dropless: a token
    reaches an expert at most once, so T slots an expert), sum the
    combined outputs over the expert (and ff) axes and keep this rank's
    rows. The dropless a2a plan's result at ~1% of its bytes."""
    if torch.is_grad_enabled() and xf.requires_grad:
        raise NotImplementedError("the decode plan's MoE takes no gradient")
    E, K, d = cfg.n_experts, cfg.top_k, xf.shape[-1]
    T_loc = xf.shape[0]
    g = mesh.get_group(ep_axis)
    E_loc = E // mesh.size(ep_axis)
    e0 = mesh.coord(ep_axis) * E_loc
    xg = col.all_gather(xf, g, 0)
    T = xg.shape[0]
    ads = col.all_gather(token_ads, g, 0) if token_ads is not None else None
    ids, wts = route(xg, rw, E, K)
    local = (ids >= e0) & (ids < e0 + E_loc)
    ids_masked = torch.where(local, ids - e0, E_loc)   # E_loc: no expert here
    C = max(4, -(-T // 4) * 4)
    xe, slot_tok, pair_slot, sizes = dispatch(xg, ids_masked, C, E_loc + 1)
    row_adapter = None
    if lora is not None and ads is not None:
        row_adapter = torch.where(slot_tok < T, ads[slot_tok.clamp(max=T - 1)],
                                  -1).to(torch.int32)[:E_loc * C]
    y = expert_ffn(xe[:E_loc], wg, wu, wd, lora=lora,
                   row_adapter=row_adapter, lora_scale=lora_scale,
                   group_sizes=sizes[:E_loc], expert_offset=e0)
    # the pairs of other ranks' experts read the zero rows of the last bucket
    y = torch.cat([y.reshape(-1, d), y.new_zeros((C, d))])
    out = combine(y, pair_slot, wts)
    axes = (ep_axis,) + ((ff_axis,) if ff_axis else ())
    out = col.all_reduce(out, mesh.get_group(axes))
    r = mesh.coord(ep_axis)
    return out[r * T_loc:(r + 1) * T_loc]
