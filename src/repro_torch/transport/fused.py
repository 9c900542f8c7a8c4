"""GPU-initiated transport: the disaggregated decode step as one CUDA graph
per shape bucket, the counterpart of ``repro.transport.fused``.

The host plane re-enters Python 2 x n_layers times a step because replica
routing (``ServerPool.compute``'s per-replica masking) happens there. This
plane moves it into device buffers:

  DeviceLoraView : the replicas' slot pools stacked layer-major,
                   (L, R*M, E, d_in, r) per hook factor, an adapter ->
                   slot table (home*M + slot on the adapter's affinity home
                   ``aid % R``, -1 = not resident) padded to a power of
                   two, and the slot ranks (R*M,). Its ``compute`` has the
                   LoRA Server's contract and launches ``ops.bgmv_expert``
                   once a hook over the layer's stacked pool: the kernel's
                   d_in split plan depends only on (dtype, d_in, r), so one
                   launch gives the bits of the host plane's per-replica
                   launches summed with exact zeros.
  FusedTransport : on the card, captures the whole step (attention, base
                   expert GEMMs, both hooks of every layer, the dense
                   layout's gather and scatter, the greedy select) once per
                   (bucket, layout) into a ``torch.cuda.CUDAGraph`` and
                   replays it: one host dispatch a step. On the CPU it runs
                   the same step eagerly, through the plain versions.

The view is rewritten in place only when the pool's residency changed
(``LoRACache.drain_dirty`` -> ``ServerPool.sync`` bump the counters this
transport fingerprints), never on the token path, so a replay reads the
new tables without a new capture. A change that alters a buffer's shape or
address (the replica count, the slot count, the table's length) drops the
captured graphs, and the next step captures again. With one replica the
view's pools are the server's own (fixed addresses, written in place by
``insert``); with more they are a copy that ``refresh`` keeps up to date,
rewriting only the slots whose weights were written since the last one.
An engine that releases its KV (a retired instance) makes the transport
forget the graphs captured over it (``forget_kv``).

Under a mesh (params whose expert weights ``shard_serve_params`` cut into
blocks) the step runs its base expert GEMMs one ``gmm`` a block, and is
still one graph a (bucket, layout). A block on another card runs on that card's side stream,
which the capture joins through events, and writes only staging buffers
made at the warm-up (``moe.Remote``): the capture allocates nothing on
that card, whose allocator takes no part in it.
"""
from __future__ import annotations

import gc
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.obs.clock import wall_time
from repro_torch.transport.base import (TransportStats, decode_tokens,
                                        eager_step)

POOL_NAMES = ("up_A", "up_B", "down_A", "down_B")


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class DeviceLoraView:
    """Device-resident LoRA routing state: stacked slot pools
    (L, R*M, E, d_in, r) per hook factor, the adapter -> slot table and the
    per-slot ranks the hook pays (the pool rank where a slot is empty or
    rank awareness is off)."""

    def __init__(self, pools: Dict[str, torch.Tensor], slot_lut, slot_ranks,
                 r_pool: int):
        self.pools = pools
        self.slot_lut = slot_lut
        self.slot_ranks = slot_ranks
        self.r_pool = r_pool

    def buffers(self) -> List[torch.Tensor]:
        return [*self.pools.values(), self.slot_lut, self.slot_ranks]

    def compute(self, hook: str, layer: int, rows, adapter_ids, expert_ids):
        """rows (T, d_in); adapter_ids, expert_ids (T,) on the device ->
        deltas (T, d_out) f32, exact zeros for absent or inactive rows."""
        A = self.pools["up_A" if hook == "up" else "down_A"][layer]
        B = self.pools["up_B" if hook == "up" else "down_B"][layer]
        n = self.slot_lut.shape[0]
        ids = adapter_ids.long()
        ok = (ids >= 0) & (ids < n)
        slots = torch.where(ok, self.slot_lut[ids.clamp(0, n - 1)], -1)
        ranks = torch.where(slots >= 0,
                            self.slot_ranks[slots.long().clamp_min(0)],
                            self.r_pool).to(torch.int32)
        return ops.bgmv_expert(rows.contiguous(), A, B,
                               slots.to(torch.int32),
                               expert_ids.to(torch.int32), ranks, self.r_pool)


def fused_hook_delta(view: DeviceLoraView, hook: str, layer: int, rows,
                     adapter_ids, expert_ids):
    """One hook's delta through the device view (the test entry point; the
    serving path runs ``view.compute`` inside the fused step)."""
    return view.compute(hook, layer, rows, adapter_ids, expert_ids)


class _CapturedStep:
    """The CUDA graph of one (bucket, layout), with its fixed-address
    inputs: tokens, positions and adapter ids, then the block table
    (B, nb) (paged) or ``sel`` and ``scatter_idx`` (dense), packed in one
    int32 buffer filled by one copy from pinned host memory, and the lora
    scale."""

    def __init__(self, B: int, nb: int, dev):
        self.B, self.nb = B, nb
        width = B * (3 + (nb if nb else 2))
        self.host = torch.empty(width, dtype=torch.int32, pin_memory=True)
        self.inputs = torch.empty(width, dtype=torch.int32, device=dev)
        self.scale = torch.zeros((), dtype=torch.float32, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        self.tokens: Optional[torch.Tensor] = None

    def load(self, toks, pos_vec, adapter_ids, lora_scale, sel, scatter_idx,
             block_table) -> None:
        B = self.B
        h = self.host.numpy()
        h[:B] = np.asarray(toks).reshape(-1)
        h[B:2 * B] = pos_vec
        h[2 * B:3 * B] = adapter_ids
        if self.nb:
            h[3 * B:] = np.asarray(block_table).reshape(-1)
        else:
            h[3 * B:4 * B] = sel
            h[4 * B:] = scatter_idx
        # the last step's read of its tokens synchronised the stream, so
        # no earlier copy still reads the pinned buffer
        self.inputs.copy_(self.host, non_blocking=True)
        self.scale.fill_(float(lora_scale))

    def step_args(self):
        B, x = self.B, self.inputs
        args = dict(toks=x[:B].view(B, 1), pos_vec=x[B:2 * B],
                    adapter_ids=x[2 * B:3 * B])
        if self.nb:
            args["block_table"] = x[3 * B:].view(B, self.nb)
        else:
            args["sel"], args["scatter_idx"] = x[3 * B:4 * B], x[4 * B:]
        return args


class FusedTransport:
    """One host dispatch per decode step; table uploads off the token path.

    ``captures`` lists one diagnostic a capture (bucket, layout, warm-up
    and capture seconds, the kernel launches the graph holds, the memory
    the capture added to the graph pool); ``copied_bytes`` counts the
    bytes ``refresh`` copied into the stacked pools (R > 1)."""

    name = "fused"

    def __init__(self, server, n_adapters: Optional[int] = None):
        self.server = server
        self.n_adapters = n_adapters
        self.stats = TransportStats(transport="fused")
        self.view: Optional[DeviceLoraView] = None
        self._fingerprint = None
        self._stack: Optional[Dict[str, torch.Tensor]] = None
        # per stacked replica: (weak ref, slot_writes) as last copied
        self._copied: List[Optional[tuple]] = []
        self.copied_bytes = 0
        self._sig = None
        self._graphs: Dict[tuple, _CapturedStep] = {}
        self._pool = None             # graph memory pool of every capture
        self._stream = None
        self.captures: List[Dict] = []

    # ------------------------- residency upload ----------------------- #
    def _replicas(self):
        reps = getattr(self.server, "replicas", None)
        return list(reps) if reps is not None else [self.server]

    def _current_fingerprint(self, reps):
        return (len(reps), getattr(self.server, "version", 0),
                bool(getattr(self.server, "rank_aware", True)),
                tuple(r.mutations for r in reps))

    def refresh(self) -> bool:
        """Rewrite the device view iff the replicas' residency, weights or
        count changed since the last upload. Returns True on upload."""
        reps = self._replicas()
        fp = self._current_fingerprint(reps)
        if fp == self._fingerprint and self.view is not None:
            return False
        for rep in reps:
            if not hasattr(rep, "pool"):
                raise ValueError("FusedTransport needs LoRAServer replicas "
                                 "with slot pools (the analytic plane has "
                                 "none)")
            if rep.y != 1 or getattr(rep, "mesh", None) is not None:
                raise ValueError("FusedTransport requires single-device "
                                 "replicas (y == 1, no server mesh): the "
                                 "stacked pool indexes layers directly")
        R, M, r = len(reps), reps[0].M, reps[0].r
        if any(rep.M != M or rep.r != r for rep in reps):
            raise ValueError("FusedTransport stacks replicas of one slot "
                             "count and rank")
        dev = reps[0].device
        max_aid = max((a for rep in reps for a in rep.slot_of), default=-1)
        need = max(self.n_adapters or 0, max_aid + 1, 1) + 1
        lut = np.full(_pow2(need), -1, np.int32)
        for i, rep in enumerate(reps):
            for aid, slot in rep.slot_of.items():
                if aid % R == i:
                    lut[aid] = i * M + slot
        if getattr(self.server, "rank_aware", True):
            ranks = np.concatenate([np.where(np.asarray(rep.slot_ranks) > 0,
                                             rep.slot_ranks, r)
                                    for rep in reps]).astype(np.int32)
        else:
            ranks = np.full(R * M, r, np.int32)
        old_lut = old_ranks = None
        if self.view is not None:
            old_lut, old_ranks = self.view.slot_lut, self.view.slot_ranks
        self.view = None
        if R > 1:
            pools = self._stacked_pools(reps)
        else:
            self._stack = None
            pools = {n: reps[0].pool[n][0] for n in POOL_NAMES}
        self.view = DeviceLoraView(pools, self._in_place(old_lut, lut, dev),
                                   self._in_place(old_ranks, ranks, dev), r)
        sig = [(t.data_ptr(), tuple(t.shape)) for t in self.view.buffers()]
        if sig != self._sig:
            self._graphs.clear()      # a buffer moved: capture again
            self._sig = sig
        self._fingerprint = fp
        self.stats.lut_uploads += 1
        return True

    @staticmethod
    def _in_place(buf, arr: np.ndarray, dev) -> torch.Tensor:
        src = torch.from_numpy(arr)
        if buf is None or tuple(buf.shape) != arr.shape:
            return src.to(dev)
        buf.copy_(src)
        return buf

    def _stacked_pools(self, reps) -> Dict[str, torch.Tensor]:
        """(L, R*M, E, ...) copies of the replicas' pools, rewritten in
        place (a new buffer only when R or M changed): a replica not
        copied before into its place is copied whole, any other only in
        the slots whose weight writes moved since the last refresh."""
        R, M = len(reps), reps[0].M
        first = reps[0].pool
        if self._stack is None or \
                self._stack["up_A"].shape[1] != R * M or \
                self._stack["up_A"].device != first["up_A"].device:
            self._stack = None          # free the old copy first
            self._stack = {n: torch.empty(
                (t.shape[1], R * M) + tuple(t.shape[3:]), dtype=t.dtype,
                device=t.device) for n, t in first.items()}
            self._copied = []
        self._copied = (self._copied + [None] * R)[:R]
        slot_bytes = sum(buf[:, 0].numel() * buf.element_size()
                         for buf in self._stack.values())
        for i, rep in enumerate(reps):
            seen = self._copied[i]
            if seen is None or seen[0]() is not rep:
                slots = None            # the whole replica
            else:
                slots = [j for j, (a, b) in enumerate(
                    zip(seen[1], rep.slot_writes)) if a != b]
            for n, buf in self._stack.items():
                src = rep.pool[n][0]
                if slots is None:
                    buf[:, i * M:(i + 1) * M].copy_(src)
                else:
                    for j in slots:
                        buf[:, i * M + j].copy_(src[:, j])
            self.copied_bytes += slot_bytes * (M if slots is None
                                               else len(slots))
            self._copied[i] = (weakref.ref(rep), list(rep.slot_writes))
        return self._stack

    # ---------------------------- decode step ------------------------- #
    def decode_step(self, params, cfg, k, v, toks, pos_vec, adapter_ids,
                    lora_scale, *, sel=None, scatter_idx=None,
                    block_table=None):
        self.refresh()
        st = self.stats
        st.steps += 1
        st.host_dispatches += 1          # the one graph replay (or call)
        st.observe_ranks(self.server, adapter_ids)
        if k.device.type != "cuda":
            return eager_step(params, cfg, k, v, toks, pos_vec, self.view,
                              adapter_ids, lora_scale, sel, scatter_idx,
                              block_table), k, v
        B = len(pos_vec)
        nb = 0 if block_table is None else np.asarray(block_table).shape[1]
        key = (B, nb, k.data_ptr(), v.data_ptr(), tuple(k.shape), id(params),
               cfg)
        step = self._graphs.get(key)
        fresh = step is None
        if fresh:
            step = _CapturedStep(B, nb, k.device)
        step.load(toks, pos_vec, adapter_ids, lora_scale, sel, scatter_idx,
                  block_table)
        if fresh:
            self._capture(step, params, cfg, k, v)
            self._graphs[key] = step
        step.graph.replay()
        return np.asarray(step.tokens.tolist(), np.int64), k, v

    def forget_kv(self, k, v) -> None:
        """Drop the graphs captured over the KV buffers ``k``/``v`` (their
        engine released them): the graphs' memory goes back to the shared
        pool for later captures, and an engine whose KV the allocator
        places at the same address captures its own."""
        ptrs = {k.data_ptr(), v.data_ptr()}
        for key in [key for key in self._graphs if key[2] in ptrs
                    or key[3] in ptrs]:
            del self._graphs[key]

    def _capture(self, step: _CapturedStep, params, cfg, k, v) -> None:
        """Warm up once on a side stream (builds and loads the kernels,
        fills the RoPE table, sets up cuBLAS on that stream; the step it
        runs writes the same KV the replay writes), then capture the step
        into ``step.graph`` from the shared pool. A failure raises."""
        dev = k.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        args = step.step_args()
        view = self.view

        def run():
            return decode_tokens(params, cfg, k, v, server=view,
                                 lora_scale=step.scale, **args)

        cur = torch.cuda.current_stream(dev)
        s = self._stream
        t0 = wall_time()
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            run()
        cur.wait_stream(s)
        torch.cuda.synchronize(dev)
        warm_s = wall_time() - t0
        before = ops.launch_counts()
        # a CUDAGraph freed during the capture (a dead engine's graphs in a
        # reference cycle, found by the collector at some allocation) resets
        # on the capturing stream, which invalidates the capture: hold the
        # collector off until the capture ends
        collecting = gc.isenabled()
        gc.disable()
        try:
            # entering the capture empties the allocator's cache, so the
            # pool's growth is read from inside it
            with torch.cuda.graph(step.graph, pool=self._pool, stream=s):
                reserved = torch.cuda.memory_reserved(dev)
                t0 = wall_time()
                step.tokens = run()
        finally:
            if collecting:
                gc.enable()
        capture_s = wall_time() - t0
        after = ops.launch_counts()
        self.captures.append({
            "bucket": step.B, "layout": "paged" if step.nb else "dense",
            "warmup_s": warm_s, "capture_s": capture_s,
            "launches": {n: after[n] - before[n] for n in after
                         if after[n] != before[n]},
            "pool_bytes_added": torch.cuda.memory_reserved(dev) - reserved})
