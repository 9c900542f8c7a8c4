#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one NVIDIA H100 and the CUDA toolkit; imports torch, numpy and the
port only. Phases, each of which fails the run with a non-zero exit:

1. build every kernel of ``src/repro_torch/csrc`` (one nvcc per source,
   all started together) and print the build time;
2. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes (max abs error against a stated tolerance; two runs
   on the same inputs give the same bits) and time kernel, plain version
   and, where one exists, the one PyTorch call that computes the same
   function (CUDA events, L2 flushed before each run, median of 30 after
   warm-up), beside the least time the card could take: paged attention
   at the serving cell's tables and at 2048-token contexts, ``bgmv_expert``
   at both server hooks and the coupled plane's three expert deltas,
   ``bgmv`` at the coupled plane's q/k/v/o, ``gmm`` at a prefill chunk's
   dispatch (beside one ``torch.bmm`` over all experts);
3. serve 6 requests at the full width of Qwen3-235B-A22B (depth cut to 4
   of 94 layers, bf16, random weights from a seed) through each plane of
   the slot engine over the paged pool: the disaggregated plane (LoRA
   Server hooks) and the coupled plane (the S-LoRA baseline, adapters on
   all seven targets inside the model); both run their base expert GEMMs
   through ``gmm``. For each: check from the launch counters that every
   decode step and prefill chunk went through the plane's kernels;
   profile a few decode steps (kernel time by name, every port kernel's
   ms/step, the device's busy share); serve the same requests again
   through the kernels with the plain versions run on a copy of the same
   state at every step, and hold the two steps' logits together; then
   serve them through the plain versions alone and compare the greedy
   tokens;
4. the invariants at depth 2, engines in lock step, each step's logits
   held together: paged == dense on the coupled plane (the dense layout's
   attention is plain torch), and coupled == disagg on a pool of the
   expert-FFN targets (the LoRA Server's adapters);
5. the LoRA-kernel path (``repro_torch.launch.kernels.run``) at full width
   with its counters set to 0 just before: its invariants, its launch
   counts, each of its kernels held against its plain twin on the same
   bf16 inputs and timed beside its twin, its bound and, for ``gmm``, one
   ``torch.bmm`` over all experts; then the segment kernels' repairs at
   full width, each held to its twin: a rank-20 pool (not a whole 16-byte
   vector of bf16 columns) through the four forms, and
   ``sgmv_rank_grouped`` over segments whose ranks are interleaved, one
   launch per distinct rank;
6. the transport planes at the serving cell (depth 4, the same traffic):
   a pool of R = 1 and R = 2 LoRA-Server replicas, paged, and R = 1 dense,
   each through the host plane (per-hook dispatch) and the fused plane
   (one CUDA graph a decode step), each plane served 4 times by one engine
   (the fused plane captures in the first run): fused tokens == host
   tokens bit for bit, one dispatch and no hook call a fused step, each
   capture holding one step's kernels (counted at capture: a replay moves
   no Python counter), decode ms/step and tokens/s of the last 3 runs,
   capture time per bucket and the graph pool's bytes; a churn run
   through the front door (2 replicas of one slot behind a one-adapter
   cache, requests waiting for their adapter; each plane's launches
   counted and held as above: tokens equal, each capture one step's
   kernels, no launch from the host at a replay, > 2 table uploads, no
   new capture); the fused plane's profile (device ms/step,
   busy share) and one replay's device time against a whole step's host
   time. The kernels of the host plane are held against their plain
   versions in phase 3;
7. the front door (``ServeSystem`` over the ``Cluster``, the adapter
   store, the scheduler) at the same cell, counts set to 0 before each
   counted run: the main path (disaggregated, paged, fused; adapter 0's
   tokens streamed through its handle) gives phase 6's fused tokens bit
   for bit, one dispatch and no hook a step; on the same system a rank-16
   adapter loaded mid-run and served, its unload refused in flight and
   accepted after, a cancel mid-decode that gives back its slot and
   pages; two instances over one fused transport give one instance's
   tokens (the graph pool's bytes of each); the coupled plane gives phase
   3's tokens; churn through the store's disk tier (8 adapters, 4 slots,
   a host tier of 3 adapters' bytes) gives the all-resident run's tokens,
   with evictions, disk reads and no new capture, and the per-adapter
   costs of a disk-tier read (its file's pages cached, and after
   ``posix_fadvise(DONTNEED)``), the CPU staging and the upload (pageable
   and pinned), and a cold round against a warm one;
8. the elastic and analytic planes at the same cell: (a) the main path
   with ``autoscale=AutoscalePolicy(...)`` (1-2 instances, 1-2 LoRA-Server
   replicas of one GPU, a cache of 2-4 slots) over a burst, a lull, a
   burst and a lull, counts set to 0 just before: its tokens equal the
   static run's bit for bit, ``resize_cache``, ``add_instance``,
   ``drain_instance`` and ``add_replica`` each fire, each capture holds
   one step's kernels and no replay launches from the host, the graph
   pool does not grow across the second add/drain cycle and no graph
   outlives its engine's KV; the wall ms of the rounds that applied each
   action against a warm round's; (b) the cost model's nominal H100
   constants beside what the card gives (copies, a matmul) and its
   predictions beside phases 2, 5 and 6's measurements; (c) the S-LoRA vs
   InfiniLoRA comparison on the analytic plane (``launch/serve.py
   --cluster``), modelled numbers labelled as such;
9. the reference's other decoder configs, each at its published widths:
   (a) Mixtral-8x7B (depth 8 of 32, adapters of true rank 16/32/64/64 in
   a rank-64 pool, phase 3's traffic) on the main path: the engine's host
   and fused planes bit for bit with each capture holding one step's
   kernels, the front door's fused run (counts set to 0 just before) with
   the engine's tokens, the coupled plane through the front door,
   coupled == disagg in lock step on the expert-FFN pool, and each plane's
   step logits against the plain versions (held at depth 2, summed up at
   4 and 8); (b) Qwen2-72B (depth 8 of 80) on the coupled plane through
   the front door (seven ``bgmv`` a layer a step), paged == dense in lock
   step, against the plain versions (held at depth 4, summed up at 8);
   (c) every registered slot-family config at depth 1, one at a time: 2
   requests of 8 tokens on every plane the reference serves it on (moe:
   disaggregated, host == fused bit for bit, and coupled; dense and vlm:
   coupled), held against the plain versions, then one decode step of 6
   rows whose kernel calls are held to their plain versions and timed
   beside their bounds; the peak device memory of each part;
10. the static-batch API (``Engine.prefill`` / ``decode``) and the
   families only it serves: (a) qwen3-moe at full width, depth 4: 4
   prompts of 128 tokens, 24 greedy steps, adapters of true rank
   {8,16,32,32} in a rank-32 pool, through coupled on all seven targets
   with bf16 and with int8 KV, coupled on gate/up/down, disaggregated
   through a LoRAServer and through a 2-replica ServerPool; each counted
   (counts set to 0 just before prefill and before decode; 4 ``bgmv`` + 3
   ``bgmv_expert`` + 3 ``gmm`` a layer a step coupled, 2 ``bgmv_expert``
   + 3 ``gmm`` disaggregated, 4 ``bgmv_expert`` over 2 replicas), timed,
   and held against the plain versions on the same state at every step,
   two runs bit for bit; coupled (gate/up/down) == disaggregated and
   int8 against bf16 KV in lock step (each step's softmax within 0.05,
   the median step's logits within 0.11, and two planted faults of the
   int8 read beyond it); (b) rwkv6-3b, zamba2-2.7b and
   seamless-m4t-large-v2 at their published widths and depths: f32
   ``decode_step`` over 32 positions against one ``forward`` (within
   1e-3; seamless against cross caches of 1024 frames; rwkv6-3b, whose
   f32 rounding its group norm scales up, within 5e-2, with its chunked
   forward, recurrent forward and decode held within 4e-9 in f64), and
   the bf16 engine (4 prompts of 64 tokens, 32 steps) twice, bit for
   bit, its ms/step, tokens/s and peak memory;
11. the mesh-sharded serving plane at the serving cell, on a grid of
   cuda:0 and cuda:1 where two cards are visible, else cuda:0 twice (each
   line prints the visible cards, the grid, peer access and the card):
   (a) the main path under a (2, 1) mesh, a pool of 2 replicas built
   partitioned, host and fused planes through the engine (counts set to
   0 just before the fused run): the tokens of the engine without a mesh
   bit for bit, one dispatch a fused step, each capture 2 x 3 ``gmm`` + 2
   ``bgmv_expert`` + 1 ``paged_attention`` a layer; decode ms/step with
   and without the mesh, graph pool and server pool bytes; (b) grids
   (4, 1) and (2, 2) at depth 2, fused: the same tokens; (c) the EP x PP
   LoRA Server at (2, 1), (1, 2), (2, 2) at the hooks' full-width shapes
   (8192 rows, 64 active): each hook of every layer equal to the flat
   server's, x launches a hook, timed beside it; (d) the front door with
   ``mesh_shape=(2, 1)``: "needs 2 devices" on one card; on two, both
   transports give phase 7's main path tokens.
12. the training plane: (i) ``ops.bgmv`` (T = 4096 rows at the q/k/v/o
   widths), ``ops.bgmv_expert`` (the gate/up/down hooks) and ``ops.gmm``
   (the base GEMMs) at the E*C rows of a training dispatch (4096 tokens
   top-8 of 128 experts at capacity 1.25), bf16 activations and f32
   rank-8 factors, under autograd: the forward and every gradient against
   torch autograd of the plain twin on the same card, forward + backward
   timed beside a bound; (ii) ``launch/train.py --lora`` (its ``run``) at
   the serving cell's width and depth, 4 x 1024 tokens, 20 steps, counts
   set to 0 just before: the loss falls, ms a step after 3, tokens/s,
   peak GiB, each kernel's launches a step, a step's profile (device ms,
   busy share, its top kernels), and the first step's loss and
   adapter gradient norms through the kernels and through the twins on
   one state; (iv) that adapter through ``ServeSystem.load_adapter`` on
   its base weights (rank 8 in the rank-32 pool): its gate/up/down on the
   main path, all seven targets on the coupled plane, each serving the
   tokens of the engine given the same tensors directly, and how many
   differ from the untrained adapter's; (iii) ``launch/train.py`` in full
   at smollm-360m's width and depth, f32, 8 x 4096 tokens, 6 steps with
   a checkpoint at 3, then a second run with fresh objects from that
   checkpoint: its steps against the uninterrupted run's, bit for bit or
   the largest difference; a step's profile.

13. the collective-bearing SPMD steps (``distributed.steps``) over one
   NCCL world of W processes, one a card: W = 2 where two cards are
   visible, else W = 1 (every grid is then the local plan and every
   placement whole; the lines say so, and that the layout's cross-rank
   proof is the CPU's gloo world and (c)'s dry run). The parameters rest
   in the reference's layout (``steps.step_placements``), and every rank
   prints the bytes of its parameter shards (its AdamW moments, its
   cache) beside ``analysis.memory_est``'s for its grid, held equal, and
   each step's bytes as run (those shards plus the most the step
   allocated above what was live) beside memory_est's ``total_as_run``.
   Each sub-phase's single-card local step runs first on cuda:0, its
   outputs kept on the host: (i) ``jit_serve_step`` at the serving cell's
   width and depth, B 8, a cache of 2048 positions holding a 1536-token
   prompt, expert adapters of true ranks RANKS a row, 16 steps fed the
   local run's greedy tokens, on grids (1, W) (kv_seq flash-decode, the
   moe_ff psum) and (W, 1) (the all-gather MoE over "data"): each step's
   logits against the local step's on the same state (the cache gathered
   to rank 0 before the step), the median (step, row) within LOGIT_TOL
   and 90% of greedy picks equal, beside the local step's own floor
   (itself as two half batches) and the drift from the one-card run; ms a
   step, gmm / bgmv_expert launches a step, each rank's peak GiB; (ii)
   ``make_lora_train_step(axis_name="data")`` over (W, 1), phase 12's
   cut and batch split over the ranks: the first step's loss and
   all-reduced gradient norms against one card's step on the whole batch,
   the all-reduce's ms, the compressed reduction equal to its formula
   computed on the host, 5 steps of each branch with the loss falling;
   (iii) ``jit_train_step`` at depth 1 (full width, bf16, AdamW) on
   (1, W), B 2 x S 1024, one step: the loss and a sample of every updated
   parameter against the local step's; ``jit_prefill_step`` at depth 4 on
   the same grid against the local prefill's logits.

14. the analysis plane (``repro_torch.analysis``, ``launch/dryrun.py``, the
   examples); each part runs where its state lives: (a) at the end of the
   transport phase, the fused plane's decode step of its running rows
   counted by ``analysis.counter`` on the card (eagerly, the kernels'
   work from their data) and on the meta device (the kernels' shape
   form; its count must equal the card's shape-form count), its roofline
   bound against the fused ms/step measured above: its "roofline_share"
   and "mfu"; (b) in phase 13's local baseline, the analytic parameter
   and cache bytes of its serve step, which must equal the allocated
   tensors' bytes, and the workspace estimate beside the peak above them;
   (c) the dry run of Qwen3-235B-A22B at train_4k, prefill_32k and
   decode_32k on the single production mesh (one rank of 256, a fake
   process group, meta tensors) and the disaggregated split, in a
   subprocess with no card visible: each cell OK, its analytic peak,
   ``fits_80g``, bottleneck and roofline fraction, its parameters as
   run (held equal to ``params``: the reference's layout), the largest
   layer's gather at use and the logits as run; train_4k must fit a
   card (``fits_80g``); (d) every kernel bound
   this run printed comes from ``analysis.roofline.kernel_bound``, held
   within 1e-9 of the formula it replaced (``call_bound``, the LoRA-kernel
   path's ``Work``); (e) the examples: serve_disaggregated's model part on
   the card at the full widths, depth 2 ("tokens identical across
   architectures: True" held; its analytic-plane table, which runs no
   model, is left to the CPU tests), train_lora's three steps on the
   card, provision_capacity (no device) beside the dry run. (c) and
   provision_capacity run in one subprocess with no card visible,
   started before phase 12 (host cores, while the card trains) and read
   here. "phase 14: N s" and "script: N s" are printed.

It prints a ``{"kernels": [...]}`` line (rows 2, 3 and 9 with their
phase 12 readings under "train"; "launches_by_plane" with "train", the
fine-tune's run, and "spmd", phase 13's rank 0), the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --only 13`` builds the kernels and runs phase 13
alone (no kernels line).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

PAGED_TOL = 1e-4               # f32 accumulation order, bf16 inputs
HOOK_TOL = 1e-4
BGMV_TOL = 1e-4
GMM_TOL = 1e-4                 # f32 sums over d <= 4096, bf16 inputs
LORA_TOL = 1e-4                # the LoRA-kernel path: the same reason
# decode logits, kernels vs plain versions on the same state. The kernels
# sum in another order, which flips single bf16 roundings of activations
# (2^-8 relative) on their way through 4 layers: a step differs by ~1e-3.
# The router's top-8 is discrete, so a near-tie there can send a token to
# another expert and move a step's logits far more; hence the median over
# steps, and greedy picks that agree on at least 90% of the rows.
LOGIT_TOL = 1e-2
ARGMAX_AGREE = 0.9
SPIN_CYCLES = 2_000_000         # ~1 ms at the H100's 1.98 GHz boost clock
ARCH, LAYERS, SEED = "qwen3-moe-235b-a22b", 4, 0
CHECK_LAYERS = 2               # the invariants run two engines: shallow
RANKS = (8, 16, 32, 32)        # true ranks of the 4 adapters, pool rank 32


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, flush, n=30, warmup=5):
    """Median device time of ``fn`` in ms: CUDA events around each call,
    with the L2 cache flushed before each (the decode step reads gigabytes
    of expert weights between two calls of a kernel). A spin of ~1 ms on
    the card before the start event keeps the host's time to enqueue
    ``fn`` out of the window: a kernel of a few microseconds would
    otherwise measure the host's speed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(n_bytes: float, n_ops: float):
    """``analysis.roofline.bound_ms``: bytes over the H100's 3.35 TB/s or
    operations over its 989 TFLOP/s of dense bf16, the larger."""
    from repro_torch.analysis import roofline
    return roofline.bound_ms(n_bytes, n_ops)


# phase 14(d): every kernel bound this run printed, from analysis.roofline,
# held against the formula it replaced: (where, relative difference)
BOUND_CHECKS = []
BOUND_TOL = 1e-9


def kernel_bound(torch, where: str, name, args, kw=None, want=None):
    """(bound ms, bound by) of one kernel call from
    ``analysis.roofline.kernel_bound`` (its data form), held within
    BOUND_TOL of ``want`` (default: ``call_bound``'s, the formula it
    replaced) on the same call."""
    from repro_torch.analysis import roofline
    got = roofline.kernel_bound(name, args, kw or {})
    want = want or call_bound(torch, name, args, kw or {})
    rel = abs(got[0] - want[0]) / max(abs(want[0]), 1e-300)
    BOUND_CHECKS.append((where, rel))
    check(rel <= BOUND_TOL and got[1] == want[1],
          f"{where}: analysis.roofline's bound {got} against {want}")
    return got


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# ------------------------------ phase 2 ------------------------------ #
def paged_case(torch, paged, ref, flush, g, nb, pos, holes, windows):
    """Paged attention at the main path's head shape (KV=4, G=16, hd=128,
    page 16), batch 8, tables of ``nb`` pages, rows at ``pos``; ``holes``
    edits the block table. Held against the plain version and timed beside
    its bound and one SDPA call over the gathered dense KV, per window."""
    dev = torch.device("cuda")
    B, KV, G, hd, ps = len(pos), 4, 16, 128, 16
    P = B * nb + 8
    q = torch.randn(B, KV, G, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(P, ps, KV, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(P, ps, KV, hd, generator=g, device=dev).bfloat16()
    bt = torch.randperm(P, generator=g, device=dev)[: B * nb]
    bt = bt.reshape(B, nb).to(torch.int32)
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    holes(bt)
    inactive = (pos < 0) | (bt < 0).all(-1)
    cases = {}
    for window in windows:
        got = paged.paged_attention(q, k, v, bt, pos, window=window)
        again = paged.paged_attention(q, k, v, bt, pos, window=window)
        want = ref.paged_attention_ref(q, k, v, bt, pos, window)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= PAGED_TOL, f"paged_attention nb={nb} window={window}: "
              f"max abs err {err} > {PAGED_TOL}")
        check(bool(torch.all(got[inactive] == 0)), "inactive row not 0")
        check(bool(torch.equal(got, again)), "paged_attention: two runs "
              "differ")
        # where paged and dense part: the layers round attention to bf16,
        # so a last-bit f32 difference can move an element by one bf16 step
        act = ~inactive
        flips = (got[act].bfloat16() != want[act].bfloat16()).float().mean()
        # work this run's data needs: pages with a valid key, valid keys
        kp = (torch.arange(nb, device=dev)[:, None] * ps
              + torch.arange(ps, device=dev)[None, :])[None]
        p = pos.long()[:, None, None]
        valid = (bt[:, :, None] >= 0) & (kp <= p) & (p >= 0)
        if window:
            valid &= kp > p - window
        pages = int(valid.any(-1).sum())
        keys = int(valid.sum())
        b_ms, b_by = kernel_bound(torch, f"paged_attention nb={nb} "
                                  f"window={window}", "paged_attention",
                                  (q, k, v, bt, pos), {"window": window})
        ms = cuda_ms(torch, lambda w=window: paged.paged_attention(
            q, k, v, bt, pos, window=w), flush)
        plain = cuda_ms(torch, lambda w=window: ref.paged_attention_ref(
            q, k, v, bt, pos, w), flush)
        # yardstick: one SDPA call over the gathered dense KV
        S = nb * ps
        kd = k[bt.long().clamp(min=0)].reshape(B, S, KV, hd).transpose(1, 2)
        vd = v[bt.long().clamp(min=0)].reshape(B, S, KV, hd).transpose(1, 2)
        kd, vd = kd.contiguous(), vd.contiguous()
        mask = valid.reshape(B, 1, 1, S)
        qd = q.reshape(B, KV * G, 1, hd)
        lib = cuda_ms(torch, lambda m=mask: torch.nn.functional
                      .scaled_dot_product_attention(qd, kd, vd, attn_mask=m,
                                                    enable_gqa=True), flush)
        pps, n_split = paged.split_plan(B, KV, nb)
        cases[window] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": lib, "pages_read": pages,
                         "bf16_flip_share": flips.item(),
                         "keys": keys, "nb": nb, "pages_per_split": pps,
                         "splits": n_split}
        print(f"paged_attention nb={nb} window={window}: err {err:.3g} "
              f"(bf16 outputs that differ: {flips.item():.3g}) kernel "
              f"{ms:.4f} ms plain {plain:.4f} ms sdpa {lib:.4f} ms "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return cases


def paged_phase(torch, paged, ref, flush):
    """Two shapes: the serving cell's (tables of 16 pages, contexts of
    96-224 tokens, one inactive row) and 2048-token contexts (tables of
    128 pages, inactive rows, unallocated pages, a 512-key window)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)

    def long_holes(bt):
        bt[1, 94:] = -1                     # unallocated tail past pos
        bt[2, 10] = -1                      # a hole inside the context
        bt[5, :] = -1                       # inactive row without pages

    long = paged_case(torch, paged, ref, flush, g, 128,
                      [2047, 1500, 1023, 700, 255, -1, 95, 2000], long_holes,
                      (0, 512))

    def serving_holes(bt):
        bt[:, 14:] = -1                     # pages past the longest context

    serving = paged_case(torch, paged, ref, flush, g, 16,
                         [95, 130, 223, 160, -1, 200, 111, 180],
                         serving_holes, (0,))
    return {"serving": serving[0], "context_2048": long[0],
            "window_512": long[512]}


def hook_phase(torch, bgmv, ref, flush):
    """bgmv_expert at the main paths' decode shapes: E*C = 8192 rows (128
    experts x capacity 64), 64 active (8 tokens x top-8), the rest
    inactive. The disaggregated plane's two server hooks carry adapters of
    true rank 8/16/32/32 in a rank-32 pool (gate|up fused at rank 64, the
    mask on col % 32); the coupled plane's three expert deltas (gate, up,
    down) run without a rank vector. The bound counts the factor columns
    these inputs need: each row's true rank where a rank vector is given
    (the pool rank's count beside it), else the pool rank."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    M, E, C, T_tok, K, d, ff, r = 4, 128, 64, 8, 8, 4096, 1536, 32
    ranks_of_slot = torch.tensor(RANKS, dtype=torch.int32, device=dev)
    rows_n = E * C
    ids = torch.full((rows_n,), -1, dtype=torch.int32, device=dev)
    fill = [0] * E
    pairs = set()
    for t in range(T_tok):
        experts = torch.randperm(E, generator=g, device=dev)[:K].tolist()
        for e in experts:
            ids[e * C + fill[e]] = t % M
            fill[e] += 1
            pairs.add((t % M, e))
    eids = (torch.arange(rows_n, device=dev) // C).to(torch.int32)
    ranks = torch.where(ids >= 0, ranks_of_slot[ids.long().clamp(min=0)],
                        r).to(torch.int32)
    act = ids >= 0
    active = int(act.sum())
    slot_of_row = ids[act].tolist()
    out = {}
    for hook, d_in, rr, d_out, ranked in (
            ("up", d, 2 * r, 2 * ff, True), ("down", ff, r, d, True),
            ("coupled_gate", d, r, ff, False),
            ("coupled_up", d, r, ff, False),
            ("coupled_down", ff, r, d, False)):
        A = (torch.randn(M, E, d_in, rr, generator=g, device=dev) / rr)
        A = A.bfloat16()
        Bm = (torch.randn(M, E, rr, d_out, generator=g, device=dev) * 0.01)
        Bm = Bm.bfloat16()
        x = torch.randn(rows_n, d_in, generator=g, device=dev).bfloat16()
        x[ids < 0] = 0                  # inactive dispatch rows are zeros
        args = (x, A, Bm, ids, eids) + ((ranks, r) if ranked else ())
        got = bgmv.bgmv_expert(*args)
        again = bgmv.bgmv_expert(*args)
        want = ref.bgmv_expert_ref(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= HOOK_TOL, f"bgmv_expert {hook}: max abs err {err} > "
              f"{HOOK_TOL}")
        check(bool(torch.all(got[ids < 0] == 0)), "inactive rows not 0")
        check(bool(torch.equal(got, again)), f"bgmv_expert {hook}: two runs "
              f"differ")

        # the factor columns each row's mask keeps; at the pool rank
        # without the rank vector
        b_ms, b_by = kernel_bound(torch, f"bgmv_expert {hook}",
                                  "bgmv_expert", args)
        pool_ms, _ = kernel_bound(torch, f"bgmv_expert {hook} pool rank",
                                  "bgmv_expert", args[:5])
        ms = cuda_ms(torch, lambda: bgmv.bgmv_expert(*args), flush)
        plain = cuda_ms(torch, lambda: ref.bgmv_expert_ref(*args), flush)
        out[hook] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bound_ms_pool_rank": pool_ms, "rows": rows_n,
                     "active_rows": active, "factor_slices": len(pairs),
                     "d_in": d_in, "r": rr, "d_out": d_out,
                     "ranked": ranked,
                     "max_abs_out": want.abs().max().item()}
        print(f"bgmv_expert {hook}: err {err:.3g} kernel {ms:.4f} ms plain "
              f"{plain:.4f} ms bound {b_ms:.4f} ms ({b_by}; pool rank "
              f"{pool_ms:.4f} ms)", flush=True)
    return out


def bgmv_phase(torch, bgmv, ref, flush):
    """bgmv at the coupled path's four attention-projection shapes, T=8
    rows (6 active over 4 distinct adapters of true rank 8/16/32/32 in a
    rank-32 pool, 2 padding rows with id -1)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    N, T, r = len(RANKS), 8, 32
    ids = torch.tensor([0, 1, 2, 3, 0, 2, -1, -1], dtype=torch.int32,
                       device=dev)
    act = ids >= 0
    n_act, n_adapters = int(act.sum()), len(set(ids[act].tolist()))
    keep = (torch.arange(r, device=dev)[None, :]
            < torch.tensor(RANKS, device=dev)[:, None])      # (N, r)
    out = {}
    for tgt, d_in, d_out in (("q", 4096, 8192), ("k", 4096, 512),
                             ("v", 4096, 512), ("o", 8192, 4096)):
        A = torch.randn(N, d_in, r, generator=g, device=dev) / r
        Bm = torch.randn(N, r, d_out, generator=g, device=dev) * 0.01
        A = torch.where(keep[:, None, :], A, 0.0).bfloat16()
        Bm = torch.where(keep[:, :, None], Bm, 0.0).bfloat16()
        x = torch.randn(T, d_in, generator=g, device=dev).bfloat16()
        got = bgmv.bgmv(x, A, Bm, ids)
        again = bgmv.bgmv(x, A, Bm, ids)
        want = ref.bgmv_ref(x, A, Bm, ids)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= BGMV_TOL, f"bgmv {tgt}: max abs err {err} > {BGMV_TOL}")
        check(bool(torch.all(got[~act] == 0)), "bgmv padding rows not 0")
        check(bool(torch.equal(got, again)), "bgmv: two runs differ")
        # this run's data: x of the active rows, the distinct adapters'
        # factors, the ids and the output, once each
        b_ms, b_by = kernel_bound(torch, f"bgmv {tgt}", "bgmv",
                                  (x, A, Bm, ids))
        ms = cuda_ms(torch, lambda: bgmv.bgmv(x, A, Bm, ids), flush)
        plain = cuda_ms(torch, lambda: ref.bgmv_ref(x, A, Bm, ids), flush)
        out[tgt] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                    "bound_ms": b_ms, "bound_by": b_by, "T": T,
                    "active_rows": n_act, "adapters": n_adapters,
                    "d_in": d_in, "r": r, "d_out": d_out,
                    "max_abs_out": want.abs().max().item()}
        print(f"bgmv {tgt}: err {err:.3g} kernel {ms:.4f} ms plain "
              f"{plain:.4f} ms bound {b_ms:.4f} ms ({b_by})", flush=True)
    return out


def gmm_phase(torch, gmm, ref, flush, tokens=64):
    """gmm at the base expert GEMMs' shapes for the dispatch of ``tokens``
    tokens (top-8 of 128 experts, dropless C = tokens * 8; 64 = a prefill
    chunk of the main paths): gate and up (4096 -> 1536) and down (1536 ->
    4096), bf16, each held against the plain version, checked to repeat
    bit for bit, and timed beside one torch.bmm over all experts and the
    bound (the used experts' weights, the rows that hold data, the f32
    output)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)
    E, K, d, ff = 128, 8, 4096, 1536
    C = tokens * K
    picks = torch.stack([torch.randperm(E, generator=g, device=dev)[:K]
                         for _ in range(tokens)]).reshape(-1)
    sizes = torch.bincount(picks, minlength=E).to(torch.int32)
    n_rows, n_used = int(sizes.sum()), int((sizes > 0).sum())
    live = (torch.arange(C, device=dev)[None, :] < sizes[:, None])[..., None]
    xe = torch.randn(E, C, d, generator=g, device=dev)
    xe = torch.where(live, xe, 0.0).bfloat16()
    out, plain_out = {}, {}
    for name, d_in, d_out in (("gate", d, ff), ("up", d, ff),
                              ("down", ff, d)):
        w = (torch.randn(E, d_in, d_out, generator=g, device=dev)
             * d_in ** -0.5).bfloat16()
        a = xe if name != "down" else (torch.nn.functional.silu(
            plain_out["gate"]) * plain_out["up"]).bfloat16()
        got = gmm.gmm(a, w, sizes)
        again = gmm.gmm(a, w, sizes)
        want = ref.gmm_ref(a, w, sizes)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= GMM_TOL, f"gmm {name} ({tokens} tokens): max abs err "
              f"{err} > {GMM_TOL}")
        check(bool(torch.equal(got, again)), f"gmm {name}: two runs differ")
        check(bool(torch.all(got[~live.expand_as(got)] == 0)),
              f"gmm {name}: rows past group_sizes not 0")
        b_ms, b_by = kernel_bound(torch, f"gmm {name} ({tokens} tokens)",
                                  "gmm", (a, w, sizes))
        ms = cuda_ms(torch, lambda a=a, w=w: gmm.gmm(a, w, sizes), flush)
        plain = cuda_ms(torch, lambda a=a, w=w: ref.gmm_ref(a, w, sizes),
                        flush)
        lib = cuda_ms(torch, lambda a=a, w=w: torch.bmm(a, w), flush)
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                     "tokens": tokens, "C": C, "rows": n_rows,
                     "experts_used": n_used, "d_in": d_in, "d_out": d_out,
                     "max_abs_out": want.abs().max().item()}
        print(f"gmm {name} ({tokens} tokens, {n_used} experts): err "
              f"{err:.3g} kernel {ms:.4f} ms plain {plain:.4f} ms bmm "
              f"{lib:.4f} ms bound {b_ms:.4f} ms ({b_by})", flush=True)
        plain_out[name] = want
    return out


# ------------------------------ phase 5 ------------------------------ #
# name in the kernels line -> (path cases timed together, source, replaces)
LORA_ROWS = {
    "bgmv_ranked": (("bgmv_ranked",), "src/repro_torch/csrc/bgmv.cu",
                    "src/repro/kernels/bgmv.py:92"),
    "sgmv": (("sgmv",), "src/repro_torch/csrc/sgmv.cu",
             "src/repro/kernels/sgmv.py:65"),
    "sgmv_ranked": (("sgmv_ranked",), "src/repro_torch/csrc/sgmv.cu",
                    "src/repro/kernels/sgmv.py:89"),
    "fused_sgmv": (("fused_sgmv",), "src/repro_torch/csrc/sgmv.cu",
                   "src/repro/kernels/fused.py:54"),
    "fused_sgmv_ranked": (("fused_sgmv_ranked",),
                          "src/repro_torch/csrc/sgmv.cu",
                          "src/repro/kernels/fused.py:108"),
    "gmm": (("gmm_gate", "gmm_up", "gmm_down"), "src/repro_torch/csrc/gmm.cu",
            "src/repro/kernels/gmm.py:40"),
}


def lora_path_phase(torch, ops, ref, counters, flush):
    """The LoRA-kernel path once, counted; then each of its calls held
    against its twin on the same inputs and timed."""
    from repro_torch.launch import kernels as path

    for fn in counters.values():
        fn.launches = 0
    res = path.run(device="cuda", seed=SEED)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    print("lora-kernel path: " + json.dumps({
        "counts": res["counts"], "launches": launches,
        "expected_launches": res["expected_launches"]}), flush=True)
    for name, n in launches.items():
        want = res["expected_launches"].get(name, 0)
        check(n == want, f"lora-kernel path: {name} launched {n} times, "
              f"not {want}")
    for inv in res["invariants"]:
        print("invariant: " + json.dumps(inv), flush=True)
        check(inv["ok"], f"lora-kernel path: {inv['name']}: {inv['value']} "
              f"against {inv['tol']}")
    cases = {}
    for case, (op, args, work) in res["cases"].items():
        got = res["outputs"][case]
        want = getattr(ref, f"{op}_ref")(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"{case}: non-finite output")
        check(err <= LORA_TOL, f"{case}: max abs err {err} > {LORA_TOL}")
        row = {"op": op, "max_abs_err": err,
               "max_abs_out": want.abs().max().item(),
               "shapes": [list(a.shape) for a in args
                          if isinstance(a, torch.Tensor)]}
        del want
        if work is not None:   # bgmv_expert is timed at the hooks' shapes
            row["bound_ms"], row["bound_by"] = kernel_bound(
                torch, f"lora-kernel path {case}", op, args,
                want=bound_ms(work.bytes, work.operations))
            row["ms"] = cuda_ms(torch, lambda o=op, a=args:
                                getattr(ops, o)(*a), flush)
            row["plain_ms"] = cuda_ms(torch, lambda o=op, a=args: getattr(
                ref, f"{o}_ref")(*a), flush)
            row["work"] = dataclasses.asdict(work)
            if op == "gmm":
                xe, w, _ = args
                row["library_ms"] = cuda_ms(
                    torch, lambda a=xe, b=w: torch.bmm(a, b), flush)
            print(f"{case}: err {err:.3g} (|out| <= {row['max_abs_out']:.3g})"
                  f" kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms"
                  f" bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
                  + (f" bmm {row['library_ms']:.4f} ms" if op == "gmm"
                     else ""), flush=True)
        else:
            print(f"{case}: err {err:.3g} (|out| <= "
                  f"{row['max_abs_out']:.3g})", flush=True)
        cases[case] = row
    up, dn = cases["fused_sgmv"], cases["fused_sgmv_down"]
    print(f"fused_sgmv: up hook {up['ms']:.4f} ms (bound "
          f"{up['bound_ms']:.4f}); down hook, the padded cross-check of "
          f"fused_sgmv_ranked, {dn['ms']:.4f} ms (bound "
          f"{dn['bound_ms']:.4f})", flush=True)
    counts = res["counts"]
    del res
    torch.cuda.empty_cache()
    return launches, cases, counts


def repair_phase(torch, sgmv, fused, ref):
    """The segment kernels at a pool rank of 20 columns (not a whole
    16-byte vector of bf16) and d = 4096, over 64 segments of cap 16 in
    adapter order (true ranks 4/8/16/20 interleaved, one segment in five
    inactive, 1-16 rows with data each): sgmv, sgmv_ranked, fused_sgmv,
    fused_sgmv_ranked and sgmv_rank_grouped, each held to its twin at
    LORA_TOL, run twice for the same bits, inactive segments exact zeros;
    sgmv_rank_grouped launches once per distinct rank."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 5)
    S, cap, d, r, M, E = 64, 16, 4096, 20, 16, 4
    seg = torch.arange(S, device=dev)
    slot = (seg % M).to(torch.int32)
    slot[4::5] = -1
    true_rank = torch.tensor((4, 8, 16, 20), dtype=torch.int32,
                             device=dev)[torch.arange(M, device=dev) % 4]
    seg_rank = torch.where(slot >= 0, true_rank[slot.long().clamp(min=0)],
                           0).to(torch.int32)
    eid = (seg % E).to(torch.int32)
    x = torch.randn(S, cap, d, generator=g, device=dev)
    x = torch.where(torch.arange(cap, device=dev)[None, :, None]
                    <= (seg % cap)[:, None, None], x, 0.0).bfloat16()
    keep = torch.arange(r, device=dev)[None, :] < true_rank[:, None]
    A = torch.randn(M, E, d, r, generator=g, device=dev) * d ** -0.5
    Bm = torch.randn(M, E, r, d, generator=g, device=dev) * 0.01
    A = torch.where(keep[:, None, None, :], A, 0.0).bfloat16()
    Bm = torch.where(keep[:, None, :, None], Bm, 0.0).bfloat16()
    A1, B1 = A[:, 0].contiguous(), Bm[:, 0].contiguous()
    cases = {
        "sgmv": (sgmv.sgmv, ref.sgmv_ref, (x, slot, A1, B1)),
        "sgmv_ranked": (sgmv.sgmv_ranked, ref.sgmv_ranked_ref,
                        (x, slot, seg_rank, A1, B1)),
        "fused_sgmv": (fused.fused_sgmv, ref.fused_sgmv_ref,
                       (x, slot, eid, A, Bm)),
        "fused_sgmv_ranked": (fused.fused_sgmv_ranked,
                              ref.fused_sgmv_ranked_ref,
                              (x, slot, eid, seg_rank, A, Bm)),
        "sgmv_rank_grouped": (sgmv.sgmv_rank_grouped,
                              ref.sgmv_rank_grouped_ref,
                              (x, slot, seg_rank, A1, B1)),
    }
    out = {}
    for name, (fn, twin, args) in cases.items():
        before = sgmv.sgmv.launches
        got = fn(*args)
        launched = sgmv.sgmv.launches - before
        again = fn(*args)
        want = twin(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= LORA_TOL, f"repair {name} (rank-20 pool): max abs err "
              f"{err} > {LORA_TOL}")
        check(torch.equal(got, again), f"repair {name}: two runs differ")
        check(bool(torch.all(got[slot < 0] == 0)),
              f"repair {name}: inactive segments not exact zeros")
        if name == "sgmv_rank_grouped":
            check(launched == 4, f"repair {name}: {launched} launches for "
                  f"4 distinct ranks")
        out[name] = {"max_abs_err": err}
        print(f"repair {name} (pool rank {r}, d {d}, ranks interleaved): "
              f"err {err:.3g}" + (f", {launched} launches"
                                  if name == "sgmv_rank_grouped" else ""),
              flush=True)
    return out


def lora_rows(lora, plane_launches, gm_prefill, repairs):
    """Rows 4-9 of the kernels line; ``gmm``'s launches are the coupled
    plane's (it carries both planes' base expert GEMMs), its times the
    LoRA-kernel path's decode dispatch, with the prefill chunk's beside.
    Rows 5-8 (csrc/sgmv.cu) are marked redesigned, with the repairs'
    check."""
    launches, cases, counts = lora
    rows = []
    for name, (parts, source, replaces) in LORA_ROWS.items():
        got = [cases[c] for c in parts]
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=(plane_launches["coupled"][name] if name == "gmm"
                             else launches[name]), launches_by_plane={
                       **{p: n[name] for p, n in plane_launches.items()},
                       "lora_kernels": launches[name]},
                   max_abs_err=max(c["max_abs_err"] for c in got),
                   ms=sum(c["ms"] for c in got),
                   plain_ms=sum(c["plain_ms"] for c in got),
                   bound_ms=sum(c["bound_ms"] for c in got),
                   bound_by="bytes" if all(c["bound_by"] == "bytes"
                                           for c in got) else "operations",
                   library_ms=(sum(c["library_ms"] for c in got)
                               if name == "gmm" else None),
                   calls={c: cases[c] for c in parts})
        if name == "bgmv_ranked":   # padded bgmv at the same shape
            row["padded"] = cases["bgmv"]
        if source.endswith("sgmv.cu"):
            row["redesigned"] = True
            row["launch_unit"] = ("one sgmv_kernel a call, after a memset "
                                  "of its completion counts")
        if name == "sgmv":
            rg = cases["sgmv_rank_grouped"]
            row["rank_grouped"] = dict(rg, launches=counts["rank_buckets"])
            # its bound: the same bytes and operations as sgmv_ranked's
            row["rank_grouped_ms"] = rg["ms"]
            row["rank_grouped_bound_ms"] = rg["bound_ms"]
            row["repairs"] = repairs
        if name == "fused_sgmv":
            row["cross_check"] = cases["fused_sgmv_down"]
        if name == "gmm":
            row["prefill"] = gm_prefill
        rows.append(row)
    return rows


# ------------------------------ phase 3 ------------------------------ #
@contextlib.contextmanager
def plain_versions(ops, ref):
    """Route the port's kernel calls to their plain versions (on the card)."""
    names = ("paged_attention", "bgmv_expert", "bgmv", "gmm")
    saved = [getattr(ops, n) for n in names]
    ops.paged_attention = (lambda q, k, v, bt, pos, *, window=0:
                           ref.paged_attention_ref(q, k, v, bt, pos, window))
    ops.bgmv_expert = ref.bgmv_expert_ref
    ops.bgmv = ref.bgmv_ref
    ops.gmm = ref.gmm_ref
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(ops, n, fn)


CSRC = pathlib.Path(__file__).resolve().parent / "src/repro_torch/csrc"
GLOBAL_FN = re.compile(   # skips __launch_bounds__(...), __cluster_dims__(...)
    r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s+)*(\w+)\s*\(")


def port_kernels(csrc=CSRC) -> dict:
    """{source name: its __global__ functions}, read from the sources."""
    return {src.name: GLOBAL_FN.findall(src.read_text())
            for src in sorted(csrc.glob("*.cu"))}


def device_profile(torch, fn, n: int):
    """({kernel name: (device us, launches)}, wall us) of ``n`` calls of
    ``fn`` under torch.profiler, after one call outside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.clock import wall_time
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = wall_time()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (wall_time() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.device_time_total, k + 1)
    return by_name, wall_us


def profile_steps(torch, engine, requests, n_steps=4, plane=None):
    """Device kernel time by name over a few decode steps of all requests,
    and the device's busy share of the window (torch.profiler)."""
    for rid, prompt, aid in requests:
        engine.add_request(rid, prompt, aid)
    by_name, wall_us = device_profile(torch, engine.step, n_steps)
    busy_us = sum(t for t, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    port = {}   # every kernel of csrc/, in the top 12 or not: [ms, launches]
    names = [k for ks in port_kernels().values() for k in ks]
    for name, (t, n) in ranked:
        for k in names:
            if re.search(rf"(?<!\w){k}(?!\w)", name):
                ms, cnt = port.get(k, (0.0, 0))
                port[k] = [ms + t / 1e3 / n_steps, cnt + n]
    out = {**({"plane": plane} if plane else {}),
           "steps": n_steps, "rows": len(requests),
           "wall_ms_per_step": wall_us / 1e3 / n_steps,
           "device_ms_per_step": busy_us / 1e3 / n_steps,
           "device_busy_share": busy_us / wall_us if wall_us else 0.0,
           "top_kernels_ms_per_step": [[name[:90], t / 1e3 / n_steps, n]
                                       for name, (t, n) in ranked[:12]],
           "port_kernels_ms_per_step": port}
    print("profile: " + json.dumps(out), flush=True)
    return out


def step_stats(torch, cfg, lk, lp, pos):
    """One step's logits of the active rows, two versions on one state."""
    act = pos >= 0
    a = lk[act][:, : cfg.vocab_size]
    b = lp[act][:, : cfg.vocab_size]
    tk, tp = a.argmax(-1), b.argmax(-1)
    return {"finite": bool(torch.isfinite(lk).all()),
            "shape_ok": tuple(lk.shape) == (pos.shape[0], cfg.padded_vocab),
            "max_abs_diff": (a - b).abs().max().item(),
            "argmax_equal": int((tk == tp).sum()), "rows": int(act.sum()),
            "max_abs_logit": b.abs().max().item(),
            # how far below the second version's best the first's pick is
            "worst_gap": (b.gather(1, tp[:, None])
                          - b.gather(1, tk[:, None])).max().item()}


def step_summary(steps_seen) -> dict:
    """Per-step comparisons summed up: the step logits' max abs difference
    (median, max), the greedy picks that agree, the logits' scale."""
    diffs = sorted(s["max_abs_diff"] for s in steps_seen)
    return {"step_logits_max_abs_diff": {
                "median": statistics.median(diffs), "max": diffs[-1],
                "steps_over_tol": sum(d > LOGIT_TOL for d in diffs),
                "steps": len(diffs)},
            "step_argmax_equal": sum(s["argmax_equal"] for s in steps_seen),
            "step_rows": sum(s["rows"] for s in steps_seen),
            "step_worst_gap": max(s["worst_gap"] for s in steps_seen),
            "max_abs_logit": max(s["max_abs_logit"] for s in steps_seen)}


def hold_steps(steps_seen, what: str) -> dict:
    """``step_summary``; fails unless the median step's logits agree within
    LOGIT_TOL and the greedy picks on ARGMAX_AGREE."""
    out = step_summary(steps_seen)
    diff = out["step_logits_max_abs_diff"]
    agree, rows = out["step_argmax_equal"], out["step_rows"]
    check(all(s["finite"] and s["shape_ok"] for s in steps_seen),
          f"{what}: decode logits not finite or of the wrong shape")
    check(diff["median"] <= LOGIT_TOL,
          f"{what}: decode logits differ by a median {diff['median']} > "
          f"{LOGIT_TOL} ({out})")
    check(agree >= ARGMAX_AGREE * rows,
          f"{what}: greedy picks agree on only {agree} of {rows} rows")
    return out


def shadow_run(torch, ops, ref, cfg, engine, requests, traffic, step_mod,
               step_name, what: str, hold: bool = True):
    """Serve ``requests`` on ``engine`` through the kernels; at every step
    the plain versions first run on a copy of the KV, so both see the same
    state and their logits are held together (``hold_steps``; with
    ``hold`` False only summed up). Returns the served result (the
    kernels' tokens) and the summary."""
    from repro_torch.launch import serve

    steps_seen = []
    orig = getattr(step_mod, step_name)

    def shadow(params_, cfg_, k, v, tokens, pos, *rest, **kw):
        with plain_versions(ops, ref):
            lp = orig(params_, cfg_, k.clone(), v.clone(), tokens, pos,
                      *rest, **kw)[0]
        lk, k, v = orig(params_, cfg_, k, v, tokens, pos, *rest, **kw)
        steps_seen.append(step_stats(torch, cfg, lk, lp, pos))
        return lk, k, v

    setattr(step_mod, step_name, shadow)
    try:
        res = serve.serve(engine, requests, traffic)
    finally:
        setattr(step_mod, step_name, orig)
    return res, (hold_steps(steps_seen, what) if hold
                 else step_summary(steps_seen))


def serve_path(torch, ops, ref, counters, cfg, engine, requests, traffic,
               step_mod, step_name, per_layer):
    """One plane's main path: ``engine()`` makes a fresh engine whose decode
    step is ``step_mod.<step_name>``; ``per_layer`` maps each counter to
    its launches per layer per decode step and per layer per prefill chunk
    (prefill skips the last layer's MoE)."""
    from repro_torch.launch import serve

    # 1. the main path, through the kernels, counted
    eng = engine()
    for fn in counters.values():
        fn.launches = 0
    res = serve.serve(eng, requests, traffic)
    launches = {name: fn.launches for name, fn in counters.items()}
    steps = res["decode_steps"]
    print(json.dumps({"plane": step_name, "decode_steps": steps,
                      "decode_ms_per_step": res["decode_ms_per_step"],
                      "tokens_per_s": res["tokens_per_s"],
                      "generated_tokens": res["generated_tokens"],
                      "prefill_s": res["prefill_s"],
                      "prefill_chunks": res["prefill_chunks"],
                      "rows_per_step": res["rows_per_step"],
                      "launches": launches,
                      "kv_stats": eng.kv_stats(),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}),
          flush=True)
    chunks = res["prefill_chunks"]
    for name, (n, n_pre) in per_layer.items():
        want = n * cfg.n_layers * steps + n_pre * (cfg.n_layers - 1) * chunks
        check(launches[name] == want,
              f"{step_name}: {name} launched {launches[name]} times, not "
              f"{n} x {cfg.n_layers} layers x {steps} decode steps + "
              f"{n_pre} x {cfg.n_layers - 1} layers x {chunks} prefill "
              f"chunks")
    check(all(len(t) == traffic.new_tokens for t in res["tokens"].values()),
          "a request did not get all its tokens")
    check(all(0 <= x < cfg.vocab_size for t in res["tokens"].values()
              for x in t), "token out of the vocabulary")

    # 2. where the time goes
    prof = profile_steps(torch, engine(), requests)

    # 3. the same requests again through the kernels, held at every step
    # against the plain versions on the same state
    res_s, held = shadow_run(torch, ops, ref, cfg, engine(), requests,
                             traffic, step_mod, step_name,
                             f"{step_name}, kernels vs plain versions")

    # 4. the same requests through the plain versions alone
    with plain_versions(ops, ref):
        res_p = serve.serve(engine(), requests, traffic)
    diverge = {}
    for rid, toks in res["tokens"].items():
        other = res_p["tokens"][rid]
        diverge[rid] = next((i for i, (a, b) in enumerate(zip(toks, other))
                             if a != b), None)
    check(res_s["tokens"] == res["tokens"],
          f"{step_name}: two runs through the kernels gave different tokens")
    print(json.dumps({
        "plane": step_name, **held,
        "plain_decode_ms_per_step": res_p["decode_ms_per_step"],
        "plain_tokens_per_s": res_p["tokens_per_s"],
        "plain_prefill_s": res_p["prefill_s"],
        "free_run_tokens_equal": sum(
            a == b for rid in res["tokens"]
            for a, b in zip(res["tokens"][rid], res_p["tokens"][rid])),
        "free_run_tokens_total": res["generated_tokens"],
        "free_run_first_divergence": diverge}), flush=True)
    return launches, res, prof


def lock_step(torch, steps_to_watch, cfg, engines, requests, traffic,
              what: str):
    """Drive the engines through the same requests in the same two waves,
    in lock step: after each step every engine is fed the first one's
    greedy tokens, and each step's logits of the active rows are held
    against the first engine's. ``steps_to_watch``: the (module, name) of
    each decode-step function the engines call."""
    captured = []
    saved = [(mod, name, getattr(mod, name)) for mod, name in steps_to_watch]

    def capture(orig):
        def step(*args, **kw):
            out = orig(*args, **kw)
            captured.append((out[0], args[5]))
            return out
        return step

    steps_seen, free_equal = [], 0
    pending = list(requests)
    done = {rid: 0 for rid, _, _ in requests}
    steps = 0

    def admit(batch):
        for rid, prompt, aid in batch:
            for eng in engines:
                eng.add_request(rid, prompt, aid)

    for mod, name, orig in saved:
        setattr(mod, name, capture(orig))
    try:
        admit(pending[: traffic.first_wave])
        pending = pending[traffic.first_wave:]
        while pending or engines[0].active_rids():
            if pending and (steps >= traffic.second_wave_after
                            or not engines[0].active_rids()):
                admit(pending)
                pending = []
            captured.clear()
            outs = [eng.step() for eng in engines]
            (lead, pos), *others = captured
            for (logits, _), eng, out in zip(others, engines[1:], outs[1:]):
                steps_seen.append(step_stats(torch, cfg, lead, logits, pos))
                free_equal += sum(out[rid] == t for rid, t in outs[0].items())
                for s in eng.slots:   # teacher forcing
                    if s is not None:
                        s.last_token = outs[0][s.rid]
            steps += 1
            for rid in outs[0]:
                done[rid] += 1
                if done[rid] == traffic.new_tokens:
                    for eng in engines:
                        eng.evict_request(rid)
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    held = hold_steps(steps_seen, what)
    out = {"layers": cfg.n_layers, "decode_steps": steps, **held,
           "logit_tol": LOGIT_TOL, "argmax_agree_min": ARGMAX_AGREE,
           "step_tokens_equal": free_equal,
           "step_tokens_total": sum(done.values())}
    print(f"{what}: " + json.dumps(out), flush=True)
    return out


def main_paths(torch, ops, paged, bgmv, ref, counters):
    from repro_torch.core import disagg
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Engine

    traffic = serve.Traffic(adapter_ranks=RANKS)
    cfg, params, lora, ecfg = serve.build(
        ARCH, layers=LAYERS, seed=SEED, device="cuda", traffic=traffic,
        mode="disagg")
    torch.cuda.synchronize()
    requests = serve.make_requests(cfg, traffic, SEED)
    print(f"main paths: {cfg.name} d={cfg.d_model} H={cfg.n_heads} "
          f"KV={cfg.n_kv_heads} E={cfg.n_experts} top-{cfg.top_k} "
          f"layers={cfg.n_layers} vocab={cfg.vocab_size}; prompts "
          f"{[len(p) for _, p, _ in requests]}; weights+server "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    # launches per layer: (each decode step, each prefill chunk)
    off = {name: (0, 0) for name in counters
           if name not in ("paged_attention", "bgmv_expert", "bgmv", "gmm")}

    # the disaggregated plane (slice 1): attention + two server hooks
    d_launch, d_res, d_prof = serve_path(
        torch, ops, ref, counters, cfg,
        lambda: Engine(cfg, params, ecfg, device="cuda", **lora), requests,
        traffic, disagg, "disagg_decode_step_slots",
        {"paged_attention": (1, 0), "bgmv_expert": (2, 0), "bgmv": (0, 0),
         "gmm": (3, 3), **off})

    # the coupled plane: q/k/v/o deltas (bgmv) and three expert deltas
    pool = serve.build_lora(cfg, "coupled", RANKS, seed=SEED,
                            dtype=torch.bfloat16, device="cuda")["pool"]
    c_launch, c_res, c_prof = serve_path(
        torch, ops, ref, counters, cfg,
        lambda: Engine(cfg, params, ecfg, device="cuda", pool=pool),
        requests, traffic, transformer, "decode_step_slots",
        {"paged_attention": (1, 0), "bgmv_expert": (3, 0), "bgmv": (4, 0),
         "gmm": (3, 3), **off})
    print("coupled vs disagg (same traffic, same card): " + json.dumps({
        "decode_ms_per_step": {"coupled": c_res["decode_ms_per_step"],
                               "disagg": d_res["decode_ms_per_step"]},
        "tokens_per_s": {"coupled": c_res["tokens_per_s"],
                         "disagg": d_res["tokens_per_s"]},
        "device_busy_share": {"coupled": c_prof["device_busy_share"],
                              "disagg": d_prof["device_busy_share"]}}),
          flush=True)

    # the two invariants at depth CHECK_LAYERS: paged == dense on the
    # coupled plane; coupled == disagg on the pool of the expert-FFN
    # targets only (the disaggregated plane serves no attention target)
    # whose adapters the server pool holds
    cfg2, params2, pool2 = shallow(cfg, params, pool)
    lock_step(torch, [(transformer, "decode_step_slots")], cfg2, [
        Engine(cfg2, params2, dataclasses.replace(ecfg, paged=p),
               device="cuda", pool=pool2) for p in (True, False)],
        requests, traffic, "paged == dense")
    del pool, pool2
    ffn2 = shallow(cfg, params, lora["pool"])[2]
    lock_step(torch, [(transformer, "decode_step_slots"),
                      (disagg, "disagg_decode_step_slots")], cfg2, [
        Engine(cfg2, params2, ecfg, device="cuda", pool=ffn2),
        Engine(cfg2, params2, ecfg, device="cuda", server=lora["server"],
               pool=ffn2)], requests, traffic, "coupled == disagg")
    return ({"disagg": d_launch, "coupled": c_launch}, (cfg, params, ecfg),
            c_res["tokens"])


# ------------------------------ phase 6 ------------------------------ #
TIMED_RUNS = 3          # repeated runs of each plane on one engine


def slot_bytes(cfg, r: int) -> int:
    """Bytes of one LoRA-Server slot (bf16): gate|up at rank 2r, down at r,
    every expert of every layer."""
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    return 2 * cfg.n_layers * E * (d * 2 * r + 2 * r * 2 * ff + ff * r
                                   + r * d)


def plane_runs(torch, ops, cfg, params, ecfg, lora, transport, requests,
               traffic, runs, mesh_ctx=None):
    """``runs`` serves of the same requests by one engine of ``transport``
    (so the fused plane captures in the first and replays after; under
    ``mesh_ctx`` when given); each run's tokens, ms/step, tokens/s and
    kernel launches, and the engine's transport stats after the first run
    and after all."""
    from repro_torch.launch import serve
    from repro_torch.serving.engine import Engine

    eng = Engine(cfg, params, ecfg, device="cuda", transport=transport,
                 mesh_ctx=mesh_ctx, **lora)
    out = {"runs": []}
    for i in range(runs):
        before = ops.launch_counts()
        res = serve.serve(eng, requests, traffic)
        after = ops.launch_counts()
        out["runs"].append({
            "tokens": res["tokens"], "decode_steps": res["decode_steps"],
            "prefill_chunks": res["prefill_chunks"],
            "rows_per_step": res["rows_per_step"],
            "decode_ms_per_step": res["decode_ms_per_step"],
            "tokens_per_s": res["tokens_per_s"],
            "launches": {n: after[n] - before[n] for n in after
                         if after[n] != before[n]}})
        if i == 0:
            out["stats_first_run"] = eng.transport_stats()
    out["stats"] = eng.transport_stats()
    out["captures"] = list(getattr(eng.transport, "captures", []))
    return eng, out


def check_planes(cfg, host, fused, what: str, per_step: dict,
                 replicas: int, blocks: int = 1) -> dict:
    """Hold the fused plane to the host plane: the same tokens in every
    run, one dispatch and no hook call a step, each capture holding one
    step's kernels (the host plane's per step; with R > 1 the host plane
    launches the hook once per engaged replica), no Python launch on a
    replay; host: 2 x L hook calls a step. ``blocks``: the expert blocks
    of a mesh, each a ``gmm`` of its own, in prefill too."""
    L = cfg.n_layers
    want = host["runs"][0]["tokens"]
    for plane in (host, fused):
        for run in plane["runs"]:
            check(run["tokens"] == want, f"{what}: fused tokens differ from "
                  f"the host plane's")
            check(all(len(t) and all(0 <= x < cfg.vocab_size for x in t)
                      for t in run["tokens"].values()),
                  f"{what}: empty request or token out of the vocabulary")
    hs, fs = host["stats_first_run"], fused["stats_first_run"]
    steps = host["runs"][0]["decode_steps"]
    check(hs["steps"] == fs["steps"] == steps, f"{what}: step counts differ")
    check(hs["hook_dispatches"] == 2 * L * steps,
          f"{what}: host hook dispatches {hs['hook_dispatches']} != 2 x "
          f"{L} x {steps}")
    check(fs["host_dispatches"] == steps and fs["hook_dispatches"] == 0,
          f"{what}: fused plane is not one dispatch a step: {fs}")
    for cap in fused["captures"]:
        check(cap["launches"] == per_step, f"{what}: a capture holds "
              f"{cap['launches']}, one step launches {per_step}")
    chunks = host["runs"][0]["prefill_chunks"]
    prefill = 3 * blocks * (L - 1) * chunks
    host_run = host["runs"][0]["launches"]
    for name, n in per_step.items():
        if name != "bgmv_expert" or replicas == 1:
            pre = prefill if name == "gmm" else 0
            check(host_run.get(name, 0) == n * steps + pre,
                  f"{what}: host plane launched {name} "
                  f"{host_run.get(name, 0)} times, not {n} x {steps} + "
                  f"{pre}")
    n_cap = len(fused["captures"])
    fused_run = fused["runs"][0]["launches"]
    for name, n in per_step.items():
        pre = prefill if name == "gmm" else 0
        check(fused_run.get(name, 0) == 2 * n * n_cap + pre,
              f"{what}: fused plane launched {name} "
              f"{fused_run.get(name, 0)} times from Python, not (warm-up + "
              f"capture) x {n_cap} graphs x {n} + {pre}: a replay launched "
              f"from the host")
    for later in fused["runs"][1:]:
        check(later["launches"] == {"gmm": prefill}, f"{what}: a replay "
              f"launched from Python: {later['launches']}")
    return {"tokens_equal": True, "decode_steps": steps,
            "captures": n_cap, "per_step_launches": per_step}


def summary(plane) -> dict:
    later = plane["runs"][1:] or plane["runs"]
    return {"decode_ms_per_step": [r["decode_ms_per_step"] for r in later],
            "tokens_per_s": [r["tokens_per_s"] for r in later],
            "first_run_decode_ms_per_step":
                plane["runs"][0]["decode_ms_per_step"],
            "stats": plane["stats_first_run"]}


def transport_phase(torch, ops, smi, cfg, params, ecfg):
    """The transport planes at the serving cell: the same traffic through
    a pool of R = 1 and R = 2 LoRA-Server replicas, host plane then fused
    plane (one CUDA graph a step), paged, and R = 1 dense, each plane
    served TIMED_RUNS + 1 times by one engine (the fused plane captures in
    the first run); then a churn run (2 slots a replica, so residency
    changes mid-run); then the fused plane's profile."""
    from repro_torch.launch import serve
    from repro_torch.serving.engine import Engine

    traffic = serve.Traffic(adapter_ranks=RANKS)
    requests = serve.make_requests(cfg, traffic, SEED)
    L, n_ad = cfg.n_layers, len(RANKS)
    per_slot = slot_bytes(cfg, max(RANKS))
    free, total = torch.cuda.mem_get_info()
    need = 2 * 2 * n_ad * per_slot          # R = 2: replicas + the view
    print(f"transport: a slot holds {per_slot / 2**30:.3f} GiB at depth "
          f"{L}; R = 2 needs {need / 2**30:.2f} GiB (replicas + stacked "
          f"view), free {free / 2**30:.2f} of {total / 2**30:.2f} GiB; "
          f"card {smi}", flush=True)
    check(need < free, "transport: R = 2 does not fit the card")
    cells = {}
    for R, paged in ((1, True), (2, True), (1, False)):
        name = f"R={R} {'paged' if paged else 'dense'}"
        lora = serve.build_pool(cfg, RANKS, R, seed=SEED,
                                dtype=torch.bfloat16, device="cuda")
        ec = dataclasses.replace(ecfg, paged=paged)
        per_step = {"gmm": 3 * L, "bgmv_expert": 2 * L,
                    **({"paged_attention": L} if paged else {})}
        planes, refresh = {}, {}
        for transport in ("host", "fused"):
            eng, planes[transport] = plane_runs(
                torch, ops, cfg, params, ec, lora, transport, requests,
                traffic, TIMED_RUNS + 1)
            if R > 1 and transport == "fused":
                refresh = {"refresh": refresh_cost(torch, eng, lora)}
            del eng
        held = check_planes(cfg, planes["host"], planes["fused"], name,
                            per_step, R)
        caps = planes["fused"]["captures"]
        if name == "R=1 paged":
            fused_tokens = planes["fused"]["runs"][-1]["tokens"]
        cells[name] = {
            **held, "host": summary(planes["host"]),
            "fused": summary(planes["fused"]),
            "capture_s": {c["bucket"]: c["capture_s"] for c in caps},
            "warmup_s": {c["bucket"]: c["warmup_s"] for c in caps},
            "graph_pool_bytes": sum(c["pool_bytes_added"] for c in caps),
            **refresh}
        print(f"transport {name}: " + json.dumps(cells[name])
              + f"; card {smi}", flush=True)
        del lora, planes
        torch.cuda.empty_cache()

    churn_cell(torch, ops, smi, cfg, params, traffic, requests)

    # the fused plane's device time and busy share, and one replay's time
    lora = serve.build_pool(cfg, RANKS, 1, seed=SEED, dtype=torch.bfloat16,
                            device="cuda")
    eng = Engine(cfg, params, ecfg, device="cuda", transport="fused", **lora)
    prof = profile_steps(torch, eng, requests, plane="fused R=1 paged")
    replay = replay_vs_step(torch, eng)
    print("transport fused plane, all 6 requests: " + json.dumps({
        **{k: prof[k] for k in ("device_ms_per_step", "wall_ms_per_step",
                                "device_busy_share")}, **replay})
          + f"; card {smi}", flush=True)
    roofline_cell(torch, smi, cfg, params, eng, statistics.median(
        cells["R=1 paged"]["fused"]["decode_ms_per_step"]), replay)
    del eng, lora
    torch.cuda.empty_cache()
    return fused_tokens, prof


def churn_cell(torch, ops, smi, cfg, params, traffic, requests) -> dict:
    """The transport phase's churn cell through the front door: 2 replicas
    of one slot each behind a one-adapter cache, so a request waits until
    its adapter is the resident one (4 residency changes for the 6
    requests), the same pool for the host and the fused plane, each run's
    launches counted: ``check_planes`` (tokens equal, one dispatch and no
    hook a fused step, each capture one step's kernels, no launch from the
    host at a replay, the host plane's launches), > 2 table uploads, no
    new capture."""
    from repro_torch.launch import serve
    L = cfg.n_layers
    pool = serve.adapter_pool(cfg, "disagg", RANKS, seed=SEED,
                              dtype=torch.bfloat16, device="cuda")
    planes, evictions = {}, {}
    for t in ("host", "fused"):
        system = front_door(serve, params, pool, traffic, transport=t,
                            replicas=2, adapter_cache_slots=1)
        cl = system.backend.cluster
        before = ops.launch_counts()
        res = serve.serve_system(system, requests, traffic)
        after = ops.launch_counts()
        stats = res["transport_stats"]
        planes[t] = {"runs": [{
            "tokens": res["tokens"], "decode_steps": stats["steps"],
            "prefill_chunks": sum(e.prefill_chunks
                                  for e in cl.engines.values()),
            "launches": {n: after[n] - before[n] for n in after
                         if after[n] != before[n]}}],
            "stats_first_run": stats, "stats": stats,
            "captures": list(getattr(cl.transport, "captures", []))}
        evictions[t] = cl.server_pool.sync_evictions
        system.close()
        del system, cl
    held = check_planes(cfg, planes["host"], planes["fused"], "churn",
                        {"gmm": 3 * L, "bgmv_expert": 2 * L,
                         "paged_attention": L}, 2)
    check(all(len(v) == traffic.new_tokens
              for v in planes["host"]["runs"][0]["tokens"].values()),
          "churn: a request did not get all its tokens")
    fs = planes["fused"]["stats"]
    caps = planes["fused"]["captures"]
    check(fs["lut_uploads"] > 2, f"churn: {fs['lut_uploads']} uploads")
    check(len(caps) == len({c["bucket"] for c in caps}),
          "churn: a residency change recaptured a graph")
    check(all(n > 0 for n in evictions.values()), "churn: no eviction")
    churn = {**held, "lut_uploads": fs["lut_uploads"],
             "evictions": evictions,
             "launches": {t: p["runs"][0]["launches"]
                          for t, p in planes.items()},
             "host_stats": planes["host"]["stats"], "fused_stats": fs}
    print("transport churn (front door, R=2, 1 slot a replica): "
          + json.dumps(churn) + f"; card {smi}", flush=True)
    del planes, pool
    torch.cuda.empty_cache()
    return churn


def refresh_cost(torch, eng, lora, n=5) -> dict:
    """What a residency change costs the fused plane's next step at R > 1:
    adapter 1 is evicted and inserted again on its home replica (its slot's
    weights written anew), then the view's ``refresh`` copies that one
    slot into the stacked pools; against a refresh that copies every
    replica whole. Median ms between CUDA events around ``refresh``
    (host issue and copies) and the bytes it copied."""
    from repro_torch.core.lora_server import pool_tensors_from_adapter

    sp, tr, pool = lora["server"], eng.transport, lora["pool"]
    aid = 1
    rep = sp.replicas[sp.replica_for(aid)]
    tensors = pool_tensors_from_adapter(pool, aid)
    out = {}
    for what in ("one_slot", "whole_view"):
        times, copied = [], set()
        for _ in range(n):
            rep.evict(aid)
            rep.insert(aid, tensors, rank=pool.rank_of(aid))
            if what == "whole_view":
                tr._copied = []         # forget what the stack holds
            before = tr.copied_bytes
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            check(tr.refresh(), "refresh: no upload after a slot write")
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            copied.add(tr.copied_bytes - before)
        check(len(copied) == 1, f"refresh {what}: copied {copied} bytes")
        out[what] = {"ms": statistics.median(times), "bytes": copied.pop()}
    slots = len(sp.replicas) * rep.M
    check(out["one_slot"]["bytes"] * slots == out["whole_view"]["bytes"],
          f"refresh: one slot's copy is not 1/{slots} of the view's: {out}")
    return out


def replay_vs_step(torch, eng, n=20) -> dict:
    """Median device time of one replay of the engine's graph for its
    running batch (CUDA events around ``replay``, inputs left as they are,
    so it rewrites the same KV cells with the same values) against the
    median host time of a whole ``Engine.step`` (inputs staged, replay,
    tokens read back, slots updated) of the same batch."""
    from repro_torch.obs.clock import wall_time

    graph = None
    steps = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = wall_time()
        eng.step()
        steps.append(1e3 * (wall_time() - t0))
        graph = graph or next(iter(eng.transport._graphs.values()))
    pairs = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        graph.graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return {"bucket": graph.B, "graphs": len(eng.transport._graphs),
            "replay_device_ms": statistics.median(
                s.elapsed_time(e) for s, e in pairs),
            "step_host_ms": statistics.median(steps)}


# ------------------------------ phase 7 ------------------------------ #
CHURN_RANKS = (8, 16, 32, 32, 8, 16, 32, 32)   # 8 adapters, pool rank 32
CHURN_REQUESTS, CHURN_WAVE = 12, 4
LIFE_RANK = 16                # the adapter loaded mid-run


def front_door(serve, params, pool, traffic, **kw):
    """A ``ServeSystem`` of the serving cell's config (``serve_config``,
    ``kw`` on top) over ``pool``; the model config is the pool's (its
    targets are the adapters' the store validates)."""
    from repro_torch.serving.api import build_system
    return build_system(serve.serve_config(traffic, **kw), pool.cfg,
                        params=params, pool=pool)


def graph_pool_bytes(system) -> int:
    tr = system.backend.cluster.transport
    return sum(c["pool_bytes_added"] for c in getattr(tr, "captures", []))


def served_with_counts(torch, counters, serve, system, requests, traffic,
                       stream=None):
    """``serve.serve_system`` with every launch counter set to 0 just
    before and read just after (a fused run counts its kernels at warm-up
    and capture, not at replay)."""
    for fn in counters.values():
        fn.launches = 0
    res = serve.serve_system(system, requests, traffic, stream=stream)
    torch.cuda.synchronize()
    res["launches"] = {name: fn.launches for name, fn in counters.items()}
    return res


def check_served(cfg, res, traffic, want, what: str, kernels) -> None:
    check(res["tokens"] == want, f"{what}: tokens differ from the engine "
          f"run's")
    check(all(len(v) == traffic.new_tokens and
              all(0 <= x < cfg.vocab_size for x in v)
              for v in res["tokens"].values()),
          f"{what}: a request lacks tokens or one is out of the vocabulary")
    s = res["summary"]
    check(s.n_cancelled == 0 and s.n_censored == 0 and s.n_finished > 0,
          f"{what}: summary {s}")
    check(all(st["slots_in_use"] == 0 for st in res["kv_stats"].values()),
          f"{what}: slots still held after the drain")
    for name in kernels:
        check(res["launches"][name] > 0, f"{what}: {name} never launched")


def churn_requests(cfg, traffic):
    """12 requests over zipf-drawn adapters of CHURN_RANKS, in waves of 4
    that do not overlap (each wave arrives as the last one finishes), so
    the batches are the same whatever the cache holds: [(rid, prompt,
    adapter, arrival)]."""
    import numpy as np

    from repro_torch.serving.workload import zipf_popularity
    # seed SEED + 4 draws 7 distinct adapters: waves 2 and 3 evict
    ads = np.random.default_rng(SEED + 4).choice(
        len(CHURN_RANKS), size=CHURN_REQUESTS,
        p=zipf_popularity(len(CHURN_RANKS)))
    rng = np.random.default_rng(SEED + 3)
    lo, hi = traffic.prompt_len
    return [(rid, rng.integers(0, cfg.vocab_size,
                               int(rng.integers(lo, hi + 1))).tolist(),
             int(ads[rid]), float(rid // CHURN_WAVE * traffic.new_tokens))
            for rid in range(CHURN_REQUESTS)]


def churn_run(torch, system, requests, traffic) -> dict:
    """Drive the churn requests round by round: each round's host time
    (it ends in the tokens' read-back) and whether it inserted an adapter
    into a server slot (a cold round) or admitted nothing (a warm one)."""
    from repro_torch.obs.clock import wall_time
    cl = system.backend.cluster
    handles = [system.submit(p, a, max_new_tokens=traffic.new_tokens,
                             arrival=at, rid=rid)
               for rid, p, a, at in requests]
    sync = cl.server_pool.sync
    sync_ms = []

    def timed_sync(*args, **kw):      # staging, disk reads and uploads
        t0 = wall_time()
        out = sync(*args, **kw)
        sync_ms.append(1e3 * (wall_time() - t0))
        return out

    cl.server_pool.sync = timed_sync
    cold, cold_sync, warm = [], [], []
    while not system.backend.idle():
        inserts, chunks = cl.server_pool.sync_inserts, \
            sum(e.prefill_chunks for e in cl.engines.values())
        n_sync = len(sync_ms)
        t0 = wall_time()
        system.step()
        ms = 1e3 * (wall_time() - t0)
        if cl.server_pool.sync_inserts > inserts:
            cold.append(ms)
            cold_sync.append(sum(sync_ms[n_sync:]))
        elif sum(e.prefill_chunks for e in cl.engines.values()) == chunks:
            warm.append(ms)
    del cl.server_pool.sync
    check(all(h.state.name == "FINISHED" for h in handles),
          "churn: a request did not finish")
    return {"tokens": {h.rid: list(h.tokens) for h in handles},
            "cold_round_ms": cold, "cold_sync_ms": cold_sync,
            "warm_round_ms": warm,
            "cache": system.cache_stats(), "captures": len(
                cl.transport.captures), "buckets": len(
                {c["bucket"] for c in cl.transport.captures}),
            "inserts": cl.server_pool.sync_inserts}


def adapter_costs(torch, system, n=5) -> dict:
    """Per adapter of the pool's rank (the padded slot is what
    moves): the disk tier's read of its canonical file (written moments
    before, so from the page cache; then after asking the kernel to drop
    the file's pages), the CPU staging into the server layout, and the upload into a slot from pageable and
    from pinned host memory (median ms of ``n``, host clock, the upload
    ending in a device sync)."""
    from repro_torch.obs.clock import wall_time
    from repro_torch.store import server_tensors_from_host
    cl = system.backend.cluster
    store, rep = cl.store, cl.server_pool.replicas[0]
    aid = next(a for a in rep.slot_of if store.rank_of(a) == store.r_pool)
    out = {"adapter": aid, "canonical_bytes": store.adapter_bytes(aid)}

    def timed(fn):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = wall_time()
            got = fn()
            torch.cuda.synchronize()
            times.append(1e3 * (wall_time() - t0))
        return statistics.median(times), got

    on_disk = next((a for a in store.registered_ids() if a in store.disk),
                   None)
    check(on_disk is not None, "churn: no adapter on the disk tier")
    # the file was written moments ago: read as it is, its pages are in
    # the page cache; then read after asking the kernel to drop them
    out["tier_read_ms_page_cache"], _ = timed(
        lambda: store.disk.get(on_disk))

    def dropped_read():
        fd = os.open(store.disk.path(on_disk), os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
        t0 = wall_time()
        store.disk.get(on_disk)
        return 1e3 * (wall_time() - t0)
    out["tier_read_ms_after_dontneed"] = statistics.median(
        dropped_read() for _ in range(n))
    out["tier_read_bytes"] = store.adapter_bytes(on_disk)
    host = store.host_tensors(aid)
    out["staging_ms"], staged = timed(
        lambda: server_tensors_from_host(store.cfg, host, store.r_pool))
    out["slot_bytes"] = sum(t.numel() * t.element_size()
                            for t in staged.values())
    rank = store.rank_of(aid)
    for what, tensors in (("pageable", staged),
                          ("pinned", {k: v.pin_memory()
                                      for k, v in staged.items()})):
        def upload():
            rep.evict(aid)
            rep.insert(aid, tensors, rank=rank)
        out[f"upload_{what}_ms"], _ = timed(upload)
    return out


def front_door_phase(torch, counters, smi, cfg, params, want_fused,
                     want_coupled):
    """Phase 7: the serving cell through the front door (``ServeSystem``
    on the ``Cluster``): the main path (disaggregated, paged, fused), the
    coupled plane, churn through the adapter store's disk tier, the
    adapter lifecycle and a cancel, two instances over one transport."""
    from repro_torch.launch import serve
    from repro_torch.store import random_host_tensors

    traffic = serve.Traffic(adapter_ranks=RANKS)
    requests = serve.make_requests(cfg, traffic, SEED)
    pool = serve.adapter_pool(cfg, "disagg", RANKS, seed=SEED,
                              dtype=torch.bfloat16, device="cuda")

    # 1. the main path: 6 requests, adapter 0's streamed, drained; traced,
    # so each decode step's host time is a span's wall_ms
    system = front_door(serve, params, pool, traffic, transport="fused",
                        trace=True)
    res = served_with_counts(torch, counters, serve, system, requests,
                             traffic, stream=0)
    ts = res["transport_stats"]
    check_served(cfg, res, traffic, want_fused, "front door (fused)",
                 ("paged_attention", "bgmv_expert", "gmm"))
    check(res["streamed"] == res["tokens"][0],
          "front door: the streamed tokens are not the request's")
    check(ts["host_dispatches"] == ts["steps"] > 0 and
          ts["hook_dispatches"] == 0,
          f"front door: not one dispatch and no hook a step: {ts}")
    one_pool = graph_pool_bytes(system)
    main = {k: res[k] for k in ("rounds", "wall_ms_per_round",
                                "generated_tokens", "tokens_per_s",
                                "launches", "transport_stats",
                                "cache_stats")}
    main.update(summary=dataclasses.asdict(res["summary"]),
                graph_pool_bytes=one_pool, tokens_equal_phase6=True)
    # the same requests again on the warm system (graphs captured,
    # adapters resident; the same waves, so the same batches)
    warm = serve.serve_system(system, requests, traffic, stream=0)
    caps = system.backend.cluster.transport.captures
    check(warm["tokens"] == want_fused and
          len(caps) == len({c["bucket"] for c in caps}),
          "front door (warm): tokens differ or a graph was captured again")
    steps = [s.args["wall_ms"] for s in
             system.observability().tracer.spans if s.name == "decode.step"]
    check(len(steps) == res["rounds"] + warm["rounds"],
          f"front door: {len(steps)} decode steps traced")
    main["decode_step_ms_median"] = statistics.median(steps[:res["rounds"]])
    main["warm"] = {k: warm[k] for k in ("rounds", "wall_ms_per_round",
                                         "tokens_per_s")}
    main["warm"]["decode_step_ms_median"] = statistics.median(
        steps[res["rounds"]:])
    print("front door main path (disagg, paged, fused): "
          + json.dumps(main) + f"; card {smi}", flush=True)
    launches = {"front_door": res["launches"]}

    # 2. the lifecycle on the same system: a rank-16 adapter loaded
    # mid-run, a request on it, unload refused in flight and accepted
    # after, a cancel mid-decode that gives back the slot and the pages
    tensors = random_host_tensors(pool.cfg, LIFE_RANK, seed=SEED + 4)
    first = [system.submit(p, a, max_new_tokens=traffic.new_tokens)
             for _, p, a in requests[:3]]
    for _ in range(3):
        system.step()
    check(system.load_adapter(len(RANKS), tensors, alpha=16.0) == LIFE_RANK,
          "lifecycle: load_adapter's rank")
    h_new = system.submit(requests[3][1], len(RANKS), max_new_tokens=8)
    h_cancel = system.submit(requests[4][1], 1, max_new_tokens=20)
    check(not any(h.done for h in (*first, h_new, h_cancel)),
          f"lifecycle: submit rejected: {[h.error for h in first]}, "
          f"{h_new.error}, {h_cancel.error}")
    while h_new.n_tokens < 1 or h_cancel.n_tokens < 2:
        system.step()
    try:
        system.unload_adapter(len(RANKS))
        check(False, "lifecycle: unload accepted while a request runs")
    except ValueError as e:
        check("in use" in str(e), f"lifecycle: {e}")
    before = system.kv_stats()[0]
    check(h_cancel.cancel(), "lifecycle: cancel refused")
    after = system.kv_stats()[0]
    check(after["slots_in_use"] == before["slots_in_use"] - 1 and
          after["pages_in_use"] < before["pages_in_use"],
          f"lifecycle: cancel kept its slot or pages: {before} -> {after}")
    system.drain()
    check(h_new.state.name == "FINISHED" and len(h_new.tokens) == 8 and
          all(h.state.name == "FINISHED" for h in first),
          "lifecycle: a request did not finish")
    system.unload_adapter(len(RANKS))
    check(system.submit(requests[3][1], len(RANKS)).state.name ==
          "REJECTED", "lifecycle: a submit to an unloaded adapter")
    final = system.kv_stats()[0]
    check(final["slots_in_use"] == 0 and final["pages_in_use"] == 0,
          f"lifecycle: KV held after the drain: {final}")
    life = {"new_adapter_tokens": h_new.tokens, "cancelled_after":
            h_cancel.n_tokens, "kv_before_cancel": before,
            "kv_after_cancel": after, "captures": len(
                system.backend.cluster.transport.captures),
            "transport_stats": system.transport_stats()}
    print("front door lifecycle: " + json.dumps(life) + f"; card {smi}",
          flush=True)
    system.close()
    del system

    # 3. two instances over one fused transport
    system = front_door(serve, params, pool, traffic, transport="fused",
                        n_instances=2)
    res2 = serve.serve_system(system, requests, traffic)
    two = {"tokens_equal_one_instance": res2["tokens"] == res["tokens"],
           "rounds": res2["rounds"],
           "wall_ms_per_round": res2["wall_ms_per_round"],
           "graph_pool_bytes": {"1": one_pool,
                                "2": graph_pool_bytes(system)},
           "captures": len(system.backend.cluster.transport.captures),
           "transport_stats": res2["transport_stats"]}
    print("front door, two instances: " + json.dumps(two) + f"; card {smi}",
          flush=True)
    check(two["tokens_equal_one_instance"],
          "two instances: tokens differ from the one-instance run")
    system.close()
    del system, pool
    torch.cuda.empty_cache()

    # 4. the coupled plane through the front door
    cpool = serve.adapter_pool(cfg, "coupled", RANKS, seed=SEED,
                               dtype=torch.bfloat16, device="cuda")
    system = front_door(serve, params, cpool, traffic, mode="coupled")
    resc = served_with_counts(torch, counters, serve, system, requests,
                              traffic)
    check_served(cfg, resc, traffic, want_coupled, "front door (coupled)",
                 ("paged_attention", "bgmv_expert", "bgmv", "gmm"))
    launches["front_door_coupled"] = resc["launches"]
    print("front door coupled: " + json.dumps(
        {k: resc[k] for k in ("rounds", "wall_ms_per_round", "tokens_per_s",
                              "launches")} | {"tokens_equal_phase3": True})
          + f"; card {smi}", flush=True)
    system.close()
    del system, cpool
    torch.cuda.empty_cache()

    # 5. churn through the store: 8 adapters, 4 slots, a host tier of 3
    # adapters' canonical bytes (the rest on disk), against 8 slots and an
    # unbounded host tier
    ctraffic = dataclasses.replace(traffic, adapter_ranks=CHURN_RANKS)
    creqs = churn_requests(cfg, ctraffic)
    pool8 = serve.adapter_pool(cfg, "disagg", CHURN_RANKS, seed=SEED + 2,
                               dtype=torch.bfloat16, device="cuda")
    budget = 3 * pool8.adapter_bytes(CHURN_RANKS.index(max(CHURN_RANKS)))
    runs = {}
    churn_kw = dict(adapter_cache_slots=4, store_host_bytes=budget)
    for name, kw in (("resident", {}), ("churn", churn_kw),
                     ("churn_no_prefetch", dict(churn_kw, prefetch=False))):
        system = front_door(serve, params, pool8, ctraffic,
                            transport="fused", **kw)
        runs[name] = churn_run(torch, system, creqs, ctraffic)
        if name == "churn":
            costs = adapter_costs(torch, system)
        system.close()
        del system
        torch.cuda.empty_cache()
    st = runs["churn"]["cache"]
    ev = sum(c["evictions"] for c in st["caches"].values())
    check(runs["churn"]["tokens"] == runs["resident"]["tokens"] ==
          runs["churn_no_prefetch"]["tokens"],
          "churn: tokens differ from the all-resident run")
    check(ev > 0 and st["store"]["disk_reads"] > 0,
          f"churn: {ev} evictions, {st['store']['disk_reads']} disk reads")
    check(all(r["captures"] == r["buckets"] for r in runs.values()),
          "churn: a residency change recaptured a graph")

    def med(xs):
        return statistics.median(xs) if xs else None
    churn = {"adapters": list(CHURN_RANKS), "requests": [
                 a for _, _, a, _ in creqs], "host_budget_bytes": budget,
             "tokens_equal_resident": True, "evictions": ev,
             "store": st["store"], "inserts": runs["churn"]["inserts"],
             "captures": runs["churn"]["captures"],
             "cold_round_ms": med(runs["churn"]["cold_round_ms"]),
             "cold_round_sync_ms": med(runs["churn"]["cold_sync_ms"]),
             "cold_rounds": len(runs["churn"]["cold_round_ms"]),
             "no_prefetch": {
                 "cold_round_ms": med(runs["churn_no_prefetch"][
                     "cold_round_ms"]),
                 "cold_round_sync_ms": med(runs["churn_no_prefetch"][
                     "cold_sync_ms"]),
                 "store": runs["churn_no_prefetch"]["cache"]["store"]},
             "warm_round_ms": med(runs["churn"]["warm_round_ms"]),
             "resident_warm_round_ms": med(runs["resident"]["warm_round_ms"]),
             "per_adapter": costs}
    print("front door churn (8 adapters, 4 slots, host tier of 3): "
          + json.dumps(churn) + f"; card {smi}", flush=True)
    del pool8
    torch.cuda.empty_cache()
    return launches


# ------------------------------ phase 8 ------------------------------ #
# (arrival round, requests): a burst, a lull, a burst, a lull
ELASTIC_WAVES = ((0.0, 12), (45.0, 1), (70.0, 12), (115.0, 1))
# the TPOT target the autoscaler's Eqs. 5-6 are held to: at a burst's
# batch (6-8 rows an instance, ~4 distinct adapters) one server GPU misses
# it and two meet it; at a lull's (1-3 rows) one meets it
ELASTIC_SLO_TPOT = 1.5e-4
CYCLE_1_END = 70.0                 # the graph pool is read here and at end
ANALYTIC_DURATION = 30.0           # virtual s of the analytic comparison


def elastic_policy():
    """The autoscaler of phase 8: a control tick every 2 rounds over a
    10-round window, 1-2 instances, 1-2 LoRA-Server replicas of one GPU,
    a cache of 2-4 slots, scale-down after one low reading, no deadband."""
    from repro_torch.serving.autoscaler import AutoscalePolicy
    return AutoscalePolicy(control_interval=2.0, window=10.0,
                           slo_tpot=ELASTIC_SLO_TPOT, min_cache_slots=2,
                           max_cache_slots=4, min_instances=1,
                           max_instances=2, min_replicas=1, max_replicas=2,
                           gpus_per_replica=1, scale_down_patience=1,
                           resize_deadband=0.0)


def elastic_requests(cfg, traffic):
    """[(rid, prompt, adapter, arrival)] of ELASTIC_WAVES: the engine
    phase's prompt lengths, adapters round-robin over RANKS."""
    import numpy as np
    rng = np.random.default_rng(SEED + 5)
    lo, hi = traffic.prompt_len
    out = []
    for at, n in ELASTIC_WAVES:
        for _ in range(n):
            rid = len(out)
            out.append((rid, rng.integers(0, cfg.vocab_size, int(
                rng.integers(lo, hi + 1))).tolist(), rid % len(RANKS), at))
    return out


def graph_pool_segments(torch, transport) -> int:
    """Bytes the caching allocator holds in the fused transport's graph
    pool (the segments of its private pool)."""
    if getattr(transport, "_pool", None) is None:
        return 0
    segs = torch.cuda.memory_snapshot()
    check(all("segment_pool_id" in sg for sg in segs),
          "elastic: the memory snapshot names no segment's pool")
    pool = tuple(transport._pool)
    return sum(sg["total_size"] for sg in segs
               if tuple(sg["segment_pool_id"]) == pool)


def elastic_run(torch, system, requests, traffic) -> dict:
    """Drive ``requests`` round by round through ``system``: each round's
    host time and scale actions, the prefill chunks of every engine that
    lived, the graph pool's bytes at the end of each lull and whether a
    graph outlived its engine's KV."""
    from repro_torch.obs.clock import wall_time
    cl = system.backend.cluster
    handles = [system.submit(p, a, max_new_tokens=traffic.new_tokens,
                             arrival=at, rid=rid)
               for rid, p, a, at in requests]
    rounds, chunks, pool_bytes, stale = [], {}, [], 0
    while not system.backend.idle():
        if not pool_bytes and cl.now >= CYCLE_1_END:
            pool_bytes.append(graph_pool_segments(torch, cl.transport))
        admitted = cl.server_pool.sync_inserts, sum(
            e.prefill_chunks for e in cl.engines.values())
        t0 = wall_time()
        evs = system.step()
        ms = 1e3 * (wall_time() - t0)
        rounds.append({"now": evs[0].time if evs else None, "ms": ms,
                       "scale": [e.kind[6:] for e in evs
                                 if e.kind.startswith("scale:")],
                       "replicas": cl.server_pool.n_replicas,
                       "instances": len(cl.engines),
                       "busy": any(e.kind == "token" for e in evs),
                       "cold": (cl.server_pool.sync_inserts, sum(
                           e.prefill_chunks for e in cl.engines.values()))
                       != admitted})
        for iid, e in cl.engines.items():
            chunks[iid] = e.prefill_chunks
        live = {e._k.data_ptr() for e in cl.engines.values()
                if e._k is not None}
        tr = cl.transport
        stale = max(stale, sum(1 for key in getattr(tr, "_graphs", {})
                               if key[2] not in live))
    pool_bytes.append(graph_pool_segments(torch, cl.transport))
    return {"handles": handles, "rounds": rounds, "chunks": chunks,
            "pool_bytes": pool_bytes, "stale_graphs": stale,
            "tokens": {h.rid: list(h.tokens) for h in handles}}


def elastic_cell(torch, counters, serve, cfg, params, pool, traffic,
                 requests) -> dict:
    """(a): the autoscaled fused main path against the static one on the
    same requests, counters set to 0 just before the autoscaled run."""
    from repro_torch.serving.api import build_system
    L = cfg.n_layers
    base = dict(transport="fused")
    static = build_system(serve.serve_config(traffic, **base), cfg,
                          params=params, pool=pool)
    want = elastic_run(torch, static, requests, traffic)
    static.close()
    del static
    torch.cuda.empty_cache()
    system = build_system(serve.serve_config(
        traffic, autoscale=elastic_policy(), **base), cfg, params=params,
        pool=pool)
    for fn in counters.values():
        fn.launches = 0
    got = elastic_run(torch, system, requests, traffic)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    cl = system.backend.cluster
    hist = system.scale_history()
    caps = list(cl.transport.captures)
    check(got["tokens"] == want["tokens"], "elastic: the autoscaled run's "
          "tokens differ from the static run's")
    check(all(h.state.name == "FINISHED" for h in got["handles"]) and all(
        len(v) == traffic.new_tokens and all(0 <= x < cfg.vocab_size
                                             for x in v)
        for v in got["tokens"].values()), "elastic: a request did not "
          "finish with all its tokens")
    fired = {}
    for r in got["rounds"]:
        for kind in r["scale"]:
            fired.setdefault(kind, []).append(r["now"])
    for kind in ("resize_cache", "add_instance", "drain_instance",
                 "add_replica"):
        check(kind in fired, f"elastic: {kind} never fired: {fired}")
    per_step = {"gmm": 3 * L, "bgmv_expert": 2 * L, "paged_attention": L}
    for cap in caps:
        check(cap["launches"] == per_step, f"elastic: a capture holds "
              f"{cap['launches']}, one step launches {per_step}")
    n_chunks = sum(got["chunks"].values())
    for name, n in per_step.items():
        pre = 3 * (L - 1) * n_chunks if name == "gmm" else 0
        check(launches[name] == 2 * n * len(caps) + pre,
              f"elastic: {name} launched {launches[name]} times from "
              f"Python, not (warm-up + capture) x {len(caps)} graphs x {n} "
              f"+ {pre}: a replay launched from the host")
    ts = cl.transport_stats()
    check(ts["host_dispatches"] == ts["steps"] and
          ts["hook_dispatches"] == 0, f"elastic: not one dispatch a step: "
          f"{ts}")
    check(got["stale_graphs"] == 0, "elastic: a graph outlived its "
          "engine's KV")
    p1, p2 = got["pool_bytes"]
    check(p2 <= p1, f"elastic: the graph pool grew from {p1} to {p2} bytes "
          f"across the second add/drain cycle")

    def med(xs):
        return statistics.median(xs) if xs else None
    warm = [r["ms"] for r in got["rounds"]
            if r["busy"] and not r["scale"] and not r["cold"]]
    by_kind = {k: [r["ms"] for r in got["rounds"] if k in r["scale"]]
               for k in fired}
    system.close()
    del system
    torch.cuda.empty_cache()
    return {"launches": launches, "report": {
        "policy": dataclasses.asdict(elastic_policy()),
        "waves": ELASTIC_WAVES, "fired_at": fired,
        "history": [{k: h[k] for k in ("now", "lb", "targets", "actions",
                                       "mean_active_rank")}
                    for h in hist if h["actions"]],
        "tokens_equal_static": True, "rounds": len(got["rounds"]),
        "static_rounds": len(want["rounds"]), "captures": len(caps),
        "per_capture": per_step, "prefill_chunks": n_chunks,
        "graph_pool_bytes": {"end_of_cycle_1": p1, "end_of_cycle_2": p2},
        "round_ms_by_action": by_kind, "warm_round_ms_median": med(warm),
        "transport_stats": ts}}


def cost_model_cell(torch, flush, cfg, requests, fused_prof, hk,
                    lora_cases) -> dict:
    """(b): the cost model's nominal H100 constants beside what this card
    gives (a device-to-device copy of 1 GiB, a pinned host-to-device copy
    of 1 GiB, one 8192^3 bf16 matmul), then its predictions beside phase
    6's fused device ms/step, phase 2's hooks and phase 5's decode gmm."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core.placement import Placement
    from repro_torch.serving.simulator import base_step_seconds, \
        disagg_stall_seconds
    hw = cm.H100
    n = 2**30
    src = torch.empty(n, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    d2d_ms = cuda_ms(torch, lambda: dst.copy_(src), flush, n=10, warmup=2)
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    h2d_ms = cuda_ms(torch, lambda: dst.copy_(host, non_blocking=True),
                     flush, n=10, warmup=2)
    del src, dst, host
    m = 8192
    a = torch.randn(m, m, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(m, m, device="cuda", dtype=torch.bfloat16)
    mm_ms = cuda_ms(torch, lambda: torch.matmul(a, b), flush, n=10,
                    warmup=3)
    del a, b
    torch.cuda.empty_cache()
    card = {"hbm_bw": 2 * n / (d2d_ms / 1e3), "host_bw": n / (h2d_ms / 1e3),
            "flops": 2 * m ** 3 / (mm_ms / 1e3)}
    constants = {k: {"nominal": getattr(hw, k), "card": v,
                     "card_over_nominal": v / getattr(hw, k)}
                 for k, v in card.items()}
    L, E = cfg.n_layers, cfg.n_experts
    rows = len(requests)
    ranks = [RANKS[aid] for _, _, aid in requests]
    # the profiled steps run after one step of every request: 1.5-4.5
    # tokens past the prompts
    ctx = statistics.mean(len(p) for _, p, _ in requests) + 3.0
    base = base_step_seconds(cfg, rows, 1, ctx, hw, 0.0)
    stall = disagg_stall_seconds(
        cfg, Placement.make("hybrid", 1, len(RANKS), L, E), rows, 1, 1,
        float(len(set(ranks))), statistics.mean(ranks), hw, True, True,
        "push")
    up, dn = hk["up"], hk["down"]
    hook_rank = statistics.mean(RANKS[t % len(RANKS)] for t in range(8))
    lora_s = cm.lora_compute_seconds(cfg, up["active_rows"],
                                     up["factor_slices"], hook_rank, hw)
    gmm_ms = sum(lora_cases[c]["ms"] for c in ("gmm_gate", "gmm_up",
                                               "gmm_down"))
    gemm_s = cm.base_moe_gemm_seconds(cfg, 8, 1, hw)
    preds = {
        "decode_step": {"model_ms": 1e3 * (base + stall),
                        "base_step_ms": 1e3 * base,
                        "disagg_stall_ms": 1e3 * stall,
                        "card_ms": fused_prof["device_ms_per_step"],
                        "what": f"fused device ms/step, {rows} rows, "
                                f"depth {L}"},
        "lora_hooks": {"model_ms": 1e3 * lora_s,
                       "card_ms": up["ms"] + dn["ms"],
                       "what": "bgmv_expert up + down, one layer"},
        "base_moe_gemm": {"model_ms": 1e3 * gemm_s, "card_ms": gmm_ms,
                          "what": "gmm gate + up + down, decode dispatch of "
                                  "8 tokens"}}
    for p in preds.values():
        p["model_over_card"] = p["model_ms"] / p["card_ms"]
    # every constant, prediction and ratio is finite and positive; the
    # step's two terms are finite and not negative (the stall is 0 where
    # the hooks hide under the base GEMMs)
    vals = [v for c in constants.values() for v in c.values()] + \
        [p[k] for p in preds.values()
         for k in ("model_ms", "card_ms", "model_over_card")]
    terms = [preds["decode_step"][k] for k in ("base_step_ms",
                                               "disagg_stall_ms")]
    check(all(math.isfinite(v) and v > 0 for v in vals) and
          all(math.isfinite(v) and v >= 0 for v in terms),
          f"cost model: a value is not finite and positive: {constants}, "
          f"{preds}")
    return {"constants": constants, "predictions": preds}


def analytic_cell() -> dict:
    """(c): the S-LoRA vs InfiniLoRA comparison of ``launch/serve.py
    --cluster`` on the analytic plane at the full config, priced with the
    nominal H100 (modelled numbers)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.obs.clock import wall_time
    t0 = wall_time()
    res = serve.compare_planes(get_config(ARCH), duration=ANALYTIC_DURATION)
    wall_s = wall_time() - t0
    check(not any(m.split(".")[0] in ("jax", "repro", "ml_dtypes")
                  for m in sys.modules), "analytic: JAX or the JAX package "
          "was imported")
    for name, s in res.items():
        check(s["n_finished"] > 0 and all(
            math.isfinite(s[k]) and s[k] >= 0
            for k in ("p95_ttft", "mean_tpot", "throughput_rps",
                      "slo_attainment")), f"analytic {name}: {s}")
    return {"duration_s": ANALYTIC_DURATION, "wall_s": wall_s,
            "summary": {name: {k: s[k] for k in (
                "n_requests", "n_finished", "p95_ttft", "mean_tpot",
                "throughput_rps", "slo_attainment")}
                for name, s in res.items()}}


def elastic_phase(torch, counters, smi, flush, cfg, params, fused_prof, hk,
                  lora_cases) -> dict:
    """Phase 8: (a) the autoscaled fused main path, (b) the cost model
    against the card, (c) the analytic plane. Returns the counted
    launches of (a)."""
    from repro_torch.launch import serve
    from repro_torch.obs.clock import wall_time
    t0 = wall_time()
    traffic = serve.Traffic(adapter_ranks=RANKS)
    pool = serve.adapter_pool(cfg, "disagg", RANKS, seed=SEED,
                              dtype=torch.bfloat16, device="cuda")
    cell = elastic_cell(torch, counters, serve, cfg, params, pool, traffic,
                        elastic_requests(cfg, traffic))
    del pool
    torch.cuda.empty_cache()
    print("elastic main path (disagg, paged, fused, autoscaled): "
          + json.dumps(cell["report"]) + f"; card {smi}", flush=True)
    cost = cost_model_cell(torch, flush, cfg,
                           serve.make_requests(cfg, traffic, SEED),
                           fused_prof, hk, lora_cases)
    print("cost model, H100 nominal vs card: " + json.dumps(cost)
          + f"; card {smi}", flush=True)
    ana = analytic_cell()
    for name, s in ana["summary"].items():
        print(f"{name:12s} p95_ttft={s['p95_ttft']:.4f}s "
              f"tpot={s['mean_tpot']:.4f}s thr={s['throughput_rps']:.2f}r/s "
              f"attain={s['slo_attainment']:.2%} (analytic, H100 nominal; "
              f"modelled, not measured)", flush=True)
    print("analytic plane: " + json.dumps(ana), flush=True)
    print(f"phase 8: {wall_time() - t0:.1f} s", flush=True)
    return cell["launches"]


# ------------------------------ phase 9 ------------------------------ #
MOE9, MOE9_LAYERS = "mixtral-8x7b", 8        # of 32
DENSE9, DENSE9_LAYERS = "qwen2-72b", 8       # of 80
RANKS9 = (16, 32, 64, 64)                    # true ranks, pool rank 64
SWEEP_ROWS = 6                               # decode rows of the timed step


def free_device(torch) -> None:
    """Give back the device memory of what the last part dropped: engines,
    transports and their graphs hold each other in cycles, which only the
    collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def plane_check(cfg, res, traffic, what: str, want=None) -> None:
    """Every request got all its tokens, each in the vocabulary (and, given
    ``want``, the tokens of another run)."""
    toks = res["tokens"]
    if want is not None:
        check(toks == want, f"{what}: tokens differ")
    check(all(len(t) == traffic.new_tokens and
              all(0 <= x < cfg.vocab_size for x in t) for t in toks.values()),
          f"{what}: a request lacks tokens or one is out of the vocabulary")


def shallow(cfg, params, pool, n: int = CHECK_LAYERS):
    """The config, weights and adapter pool cut to their first ``n``
    layers (views)."""
    cfg2 = dataclasses.replace(cfg, n_layers=n)
    params2 = dict(params, layers=_first_layers(params["layers"], n))
    pool2 = dataclasses.replace(pool, cfg=dataclasses.replace(
        pool.cfg, n_layers=n), tensors=_first_layers(pool.tensors, n))
    return cfg2, params2, pool2


def held_by_depth(torch, ops, ref, cfg, params, pool, engine_kw, requests,
                  traffic, step_mod, step_name, what: str, depths) -> dict:
    """The kernels against the plain versions on the same state
    (``shadow_run``) at each (depth, held) of ``depths``: held to
    LOGIT_TOL and ARGMAX_AGREE where ``held``, else summed up. Two sum
    orders part by a bf16 rounding of an activation here and there, and
    the logits' difference grows with depth, faster under top-2 routing
    than under phase 3's top-8. ``engine_kw(pool)``: the Engine's adapter
    arguments."""
    from repro_torch.launch import serve
    from repro_torch.serving.engine import Engine

    out = {}
    for n, hold in depths:
        c, p, pl = shallow(cfg, params, pool, n)
        res, out[f"depth_{n}"] = shadow_run(
            torch, ops, ref, c, Engine(c, p, serve.ENGINE, device="cuda",
                                       **engine_kw(pl)), requests, traffic,
            step_mod, step_name, f"{what} (depth {n})", hold=hold)
        plane_check(c, res, traffic, f"{what} (depth {n})")
        out[f"depth_{n}"]["held"] = hold
    return out


def mixtral_cell(torch, ops, ref, counters, smi) -> dict:
    """Phase 9(a): Mixtral-8x7B at full width (depth 8 of 32) on the main
    path: the engine's host and fused planes bit for bit, each capture one
    step's kernels; the front door's fused run (counts set to 0 just
    before) == the engine's tokens; the coupled plane through the front
    door; coupled == disagg in lock step on the expert-FFN pool; each plane
    against the plain versions on the same state, held at depth
    CHECK_LAYERS and summed up at depths LAYERS and 8 (``held_by_depth``)."""
    from repro_torch.core import disagg
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.obs.clock import wall_time
    from repro_torch.serving.engine import Engine

    t0 = wall_time()
    torch.cuda.reset_peak_memory_stats()
    traffic = serve.Traffic(adapter_ranks=RANKS9)
    cfg, params = serve.model(MOE9, layers=MOE9_LAYERS, seed=SEED,
                              device="cuda")
    weights = torch.cuda.memory_allocated()
    lora = serve.build_pool(cfg, RANKS9, 1, seed=SEED, dtype=torch.bfloat16,
                            device="cuda")
    requests = serve.make_requests(cfg, traffic, SEED)
    ecfg, L = serve.ENGINE, cfg.n_layers
    print(f"phase 9(a): {cfg.name} d={cfg.d_model} H={cfg.n_heads} "
          f"KV={cfg.n_kv_heads} E={cfg.n_experts} top-{cfg.top_k} "
          f"ff={cfg.d_ff} layers={L} of 32; weights "
          f"{weights / 2**30:.2f} GiB; an adapter "
          f"{lora['pool'].bytes_per_adapter() / 2**30:.3f} GiB at rank "
          f"{lora['pool'].rank}; prompts {[len(p) for _, p, _ in requests]}",
          flush=True)
    planes = {}
    for transport, runs in (("host", 1), ("fused", 2)):
        eng, planes[transport] = plane_runs(
            torch, ops, cfg, params, ecfg, lora, transport, requests,
            traffic, runs)
        del eng
    per_step = {"gmm": 3 * L, "bgmv_expert": 2 * L, "paged_attention": L}
    out = {"engine": {**check_planes(cfg, planes["host"], planes["fused"],
                                     "mixtral", per_step, 1),
                      "host": summary(planes["host"]),
                      "fused": summary(planes["fused"])}}
    fused_tokens = planes["fused"]["runs"][-1]["tokens"]

    # the main path through the front door, counts set to 0 just before
    system = front_door(serve, params, lora["pool"], traffic,
                        transport="fused")
    res = served_with_counts(torch, counters, serve, system, requests,
                             traffic)
    check_served(cfg, res, traffic, fused_tokens, "mixtral front door "
                 "(fused)", ("paged_attention", "bgmv_expert", "gmm"))
    ts = res["transport_stats"]
    check(ts["host_dispatches"] == ts["steps"] > 0 and
          ts["hook_dispatches"] == 0,
          f"mixtral front door: not one dispatch and no hook a step: {ts}")
    system.close()
    del system
    launches = {"mixtral_front_door": res["launches"]}
    out["front_door"] = {k: res[k] for k in ("rounds", "wall_ms_per_round",
                                             "tokens_per_s", "launches")}

    # the coupled plane through the front door, on the same pool (no
    # q/k/v/o target): three expert deltas a layer, no bgmv
    system = front_door(serve, params, lora["pool"], traffic,
                        mode="coupled")
    resc = served_with_counts(torch, counters, serve, system, requests,
                              traffic)
    plane_check(cfg, resc, traffic, "mixtral front door (coupled)")
    lc = resc["launches"]
    check(lc["bgmv"] == 0 and lc["bgmv_expert"] == 3 * lc["paged_attention"]
          > 0 and lc["gmm"] > 0, f"mixtral coupled: launches {lc}")
    system.close()
    del system
    launches["mixtral_front_door_coupled"] = lc
    out["front_door_coupled"] = {k: resc[k] for k in (
        "rounds", "wall_ms_per_round", "tokens_per_s", "launches")}
    out["front_door_coupled"]["tokens_equal_disagg"] = sum(
        a == b for rid in res["tokens"]
        for a, b in zip(res["tokens"][rid], resc["tokens"][rid]))

    # the invariant at depth CHECK_LAYERS, as phase 4 holds it (two sum
    # orders part by a bf16 rounding here and there, and that compounds
    # with depth); the server's slot pool holds every layer, the engines
    # read its first ones
    cfg2, params2, ffn2 = shallow(cfg, params, lora["pool"])
    out["coupled_eq_disagg"] = lock_step(
        torch, [(transformer, "decode_step_slots"),
                (disagg, "disagg_decode_step_slots")], cfg2,
        [Engine(cfg2, params2, ecfg, device="cuda", pool=ffn2),
         Engine(cfg2, params2, ecfg, device="cuda",
                server=lora["server"], pool=ffn2)], requests, traffic,
        "mixtral coupled == disagg")
    server = lora["server"]
    for plane, kw, mod, step in (
            ("disagg", lambda pl: {"server": server, "pool": pl}, disagg,
             "disagg_decode_step_slots"),
            ("coupled", lambda pl: {"pool": pl}, transformer,
             "decode_step_slots")):
        out[f"{plane}_vs_plain"] = held_by_depth(
            torch, ops, ref, cfg, params, lora["pool"], kw, requests,
            traffic, mod, step, f"mixtral {plane}, kernels vs plain "
            f"versions", ((CHECK_LAYERS, True), (LAYERS, False), (L, False)))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = wall_time() - t0
    print("phase 9(a) mixtral main path: " + json.dumps(out)
          + f"; card {smi}", flush=True)
    del params, lora
    free_device(torch)
    return launches


def dense_cell(torch, ops, ref, counters, smi) -> dict:
    """Phase 9(b): Qwen2-72B at full width (depth 8 of 80, the untied
    152064-row head) on the coupled plane through the front door: seven
    ``bgmv`` launches a layer a step, no expert kernel; paged == dense in
    lock step; the kernels against the plain versions, held at depth
    LAYERS and summed up at depth 8."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.obs.clock import wall_time
    from repro_torch.serving.engine import Engine

    t0 = wall_time()
    torch.cuda.reset_peak_memory_stats()
    traffic = serve.Traffic(adapter_ranks=RANKS9)
    cfg, params = serve.model(DENSE9, layers=DENSE9_LAYERS, seed=SEED,
                              device="cuda")
    weights = torch.cuda.memory_allocated()
    pool = serve.adapter_pool(cfg, "coupled", RANKS9, seed=SEED,
                              dtype=torch.bfloat16, device="cuda")
    requests = serve.make_requests(cfg, traffic, SEED)
    ecfg = serve.ENGINE
    print(f"phase 9(b): {cfg.name} d={cfg.d_model} H={cfg.n_heads} "
          f"KV={cfg.n_kv_heads} ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"layers={cfg.n_layers} of 80; weights {weights / 2**30:.2f} GiB; "
          f"targets {pool.cfg.lora_targets}", flush=True)
    system = front_door(serve, params, pool, traffic, mode="coupled")
    res = served_with_counts(torch, counters, serve, system, requests,
                             traffic)
    plane_check(cfg, res, traffic, "qwen2-72b front door (coupled)")
    lc = res["launches"]
    n_tgt = len(pool.cfg.lora_targets)
    check(lc["paged_attention"] > 0 and
          lc["paged_attention"] % cfg.n_layers == 0 and
          lc["bgmv"] == n_tgt * lc["paged_attention"] and
          lc["bgmv_expert"] == lc["gmm"] == 0,
          f"qwen2-72b coupled: launches {lc}, not {n_tgt} bgmv a layer a "
          f"step and no expert kernel")
    s = res["summary"]
    check(s.n_cancelled == 0 and s.n_censored == 0 and s.n_finished > 0,
          f"qwen2-72b: summary {s}")
    system.close()
    del system
    out = {"front_door": {k: res[k] for k in (
        "rounds", "wall_ms_per_round", "tokens_per_s", "launches")}}
    cfg2, params2, pool2 = shallow(cfg, params, pool)
    out["paged_eq_dense"] = lock_step(
        torch, [(transformer, "decode_step_slots")], cfg2,
        [Engine(cfg2, params2, dataclasses.replace(ecfg, paged=p),
                device="cuda", pool=pool2) for p in (True, False)],
        requests, traffic, "qwen2-72b paged == dense")
    out["coupled_vs_plain"] = held_by_depth(
        torch, ops, ref, cfg, params, pool, lambda pl: {"pool": pl},
        requests, traffic, transformer, "decode_step_slots",
        "qwen2-72b coupled, kernels vs plain versions",
        ((LAYERS, True), (cfg.n_layers, False)))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = wall_time() - t0
    print("phase 9(b) qwen2-72b coupled: " + json.dumps(out)
          + f"; card {smi}", flush=True)
    del params, pool
    free_device(torch)
    return {"qwen2_72b_front_door": lc}


class _Recorder:
    """A kernel wrapper that records each call and forwards it; the
    wrapper's launch count (which it updates through its module's global)
    stays the wrapper's own."""

    def __init__(self, name, orig, calls):
        self.name, self.orig, self.calls = name, orig, calls

    @property
    def launches(self):
        return self.orig.launches

    @launches.setter
    def launches(self, n):
        self.orig.launches = n

    def __call__(self, *args, **kw):
        self.calls.append((self.name, args, kw))
        return self.orig(*args, **kw)


@contextlib.contextmanager
def recorded(mods, calls: list):
    """Record every call of the kernel wrappers ``mods`` ({name: module})
    as (name, args, kwargs); each call still launches its kernel."""
    saved = {name: getattr(mod, name) for name, mod in mods.items()}
    for name, mod in mods.items():
        setattr(mod, name, _Recorder(name, saved[name], calls))
    try:
        yield
    finally:
        for name, mod in mods.items():
            setattr(mod, name, saved[name])


def call_bound(torch, name, args, kw):
    """(bound ms, bound by) of one recorded kernel call from its data: the
    rows that hold data, the factors or weights those rows read, the pages
    with a valid key, each output written once."""
    if name == "paged_attention":
        q, k, _, bt, pos = args
        window = kw.get("window", 0)
        B, KV, G, hd = q.shape
        ps, nb = k.shape[1], bt.shape[1]
        kp = (torch.arange(nb, device=q.device)[:, None] * ps
              + torch.arange(ps, device=q.device)[None, :])[None]
        p = pos.long()[:, None, None]
        valid = (bt[:, :, None] >= 0) & (kp <= p) & (p >= 0)
        if window:
            valid &= kp > p - window
        pages, keys = int(valid.any(-1).sum()), int(valid.sum())
        n_bytes = (q.numel() * q.element_size()
                   + pages * ps * KV * hd * k.element_size() * 2
                   + bt.numel() * 4 + pos.numel() * 4 + q.numel() * 4)
        return bound_ms(n_bytes, keys * KV * G * hd * 4)
    if name == "gmm":
        xe, w, sizes = args
        E, _, d_in = xe.shape
        d_out = w.shape[-1]
        n_rows, used = int(sizes.sum()), int((sizes > 0).sum())
        n_bytes = (n_rows * d_in * xe.element_size()
                   + used * d_in * d_out * w.element_size() + E * 4
                   + xe.shape[0] * xe.shape[1] * d_out * 4)
        return bound_ms(n_bytes, 2 * n_rows * d_in * d_out)
    x, A, B, ids = args[:4]
    T, d_in = x.shape
    r, d_out, el = A.shape[-1], B.shape[-1], A.element_size()
    act = ids >= 0
    n_act = int(act.sum())
    if name == "bgmv":
        n_ad = len(set(ids[act].tolist()))
        n_bytes = (n_act * d_in * x.element_size()
                   + n_ad * (d_in * r + r * d_out) * el + T * 4
                   + T * d_out * 4)
        return bound_ms(n_bytes, n_act * 2 * (d_in * r + r * d_out))
    eids = args[4]
    ranks = args[5] if len(args) > 5 else kw.get("ranks")
    r_mod = (args[6] if len(args) > 6 else kw.get("r_mod", 0)) or r
    col = torch.arange(r, device=x.device)
    if ranks is not None:       # factor columns each row's mask keeps
        cols = ((col[None, :] % r_mod) < ranks[:, None]).sum(-1)
    else:
        cols = torch.full((T,), r, device=x.device)
    pairs = {}
    for a, e, c in zip(ids[act].tolist(), eids[act].tolist(),
                       cols[act].tolist()):
        pairs[a, e] = max(pairs.get((a, e), 0), c)
    n_bytes = (n_act * d_in * x.element_size()
               + sum((d_in + d_out) * c * el for c in pairs.values())
               + T * d_out * 4 + (3 if ranks is not None else 2) * T * 4)
    n_ops = 2 * (d_in + d_out) * int(cols[act].sum())
    return bound_ms(n_bytes, n_ops)


def time_calls(torch, ref, flush, calls, kernels) -> list:
    """Each recorded call of the port's kernels held against its plain
    version on the same inputs and timed (CUDA events, L2 flushed, median
    of 30), beside its bound."""
    plain = {"paged_attention": lambda q, k, v, bt, pos, window=0:
             ref.paged_attention_ref(q, k, v, bt, pos, window),
             "bgmv": ref.bgmv_ref, "bgmv_expert": ref.bgmv_expert_ref,
             "gmm": ref.gmm_ref}
    tol = {"paged_attention": PAGED_TOL, "bgmv": BGMV_TOL,
           "bgmv_expert": HOOK_TOL, "gmm": GMM_TOL}
    out = []
    for i, (name, args, kw) in enumerate(calls):
        fn = kernels[name]
        # each call writes a fresh output: the plain versions take no out=
        kw = {k: v for k, v in kw.items() if k != "out"}
        got, want = fn(*args, **kw), plain[name](*args, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        shapes = [list(a.shape) for a in args if hasattr(a, "shape")]
        check(err <= tol[name], f"{name} at {shapes}: max abs err {err} > "
              f"{tol[name]}")
        check(bool(torch.isfinite(got).all()), f"{name}: not finite")
        b_ms, b_by = kernel_bound(torch, f"{name} call {i}", name, args, kw)
        ms = cuda_ms(torch, lambda: fn(*args, **kw), flush)
        out.append({"kernel": name, "call": i, "shapes": shapes,
                    "max_abs_err": err, "ms": ms, "bound_ms": b_ms,
                    "bound_by": b_by})
    return out


def sweep_config(torch, ops, ref, counters, flush, kernels, mods, name,
                 smi) -> dict:
    """Phase 9(c), one config at full width and depth 1: 2 requests of 8
    tokens on every plane the reference serves it on (moe: disaggregated
    on the host and the fused transport, bit for bit, and coupled on all
    its targets; dense and vlm: coupled), each held against the plain
    versions on the same state; then one decode step of SWEEP_ROWS rows
    on each plane, its kernel calls recorded, held to their plain versions
    and timed beside their bounds."""
    from repro_torch.core import disagg
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.obs.clock import wall_time
    from repro_torch.serving.engine import Engine

    t0 = wall_time()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = serve.model(name, layers=1, seed=SEED, device="cuda")
    r = cfg.lora_rank
    traffic = serve.Traffic(n_requests=2, adapter_ranks=(r // 2, r),
                            prompt_len=(24, 40), new_tokens=8, first_wave=2)
    requests = serve.make_requests(cfg, traffic, SEED)
    timed_requests = serve.make_requests(cfg, dataclasses.replace(
        traffic, n_requests=SWEEP_ROWS), SEED + 1)
    ecfg = serve.ENGINE
    planes = {}
    if cfg.is_moe:
        lora = serve.build_pool(cfg, traffic.adapter_ranks, 1, seed=SEED,
                                dtype=torch.bfloat16, device="cuda")
        planes["disagg"] = (lambda t="host": Engine(
            cfg, params, ecfg, device="cuda", transport=t, **lora),
            disagg, "disagg_decode_step_slots")
    pool = serve.adapter_pool(cfg, "coupled", traffic.adapter_ranks,
                              seed=SEED, dtype=torch.bfloat16,
                              device="cuda")
    planes["coupled"] = (lambda: Engine(cfg, params, ecfg, device="cuda",
                                        pool=pool),
                         transformer, "decode_step_slots")
    out = {"config": name, "family": cfg.family, "d": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "hd": cfg.head_dim,
           "ff": cfg.d_ff, "experts": [cfg.n_experts, cfg.top_k],
           "rank": r, "vocab": cfg.vocab_size, "planes": {}}
    for plane, (engine, mod, step) in planes.items():
        for fn in counters.values():
            fn.launches = 0
        res, held = shadow_run(torch, ops, ref, cfg, engine(), requests,
                               traffic, mod, step,
                               f"{name} {plane}, kernels vs plain versions")
        plane_check(cfg, res, traffic, f"{name} {plane}")
        got = {"launches": {k: fn.launches for k, fn in counters.items()
                            if fn.launches}, **held}
        if plane == "disagg":
            fused = serve.serve(engine("fused"), requests, traffic)
            plane_check(cfg, fused, traffic, f"{name} fused == host",
                        res["tokens"])
            got["fused_tokens_equal_host"] = True
        calls = []
        eng = engine()
        for rid, prompt, aid in timed_requests:
            eng.add_request(rid, prompt, aid)
        with recorded(mods, calls):
            eng.step()
        torch.cuda.synchronize()
        got["decode_step"] = time_calls(torch, ref, flush, calls, kernels)
        del eng
        out["planes"][plane] = got
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = wall_time() - t0
    print("phase 9(c) " + json.dumps(out) + f"; card {smi}", flush=True)
    del params, pool, planes
    free_device(torch)
    return out


def families_phase(torch, ops, ref, counters, flush, smi) -> dict:
    """Phase 9: the reference's other decoder configs on the card."""
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import SLOT_FAMILIES
    from repro_torch.kernels import bgmv, gmm, paged
    from repro_torch.obs.clock import wall_time

    t0 = wall_time()
    launches = mixtral_cell(torch, ops, ref, counters, smi)
    launches.update(dense_cell(torch, ops, ref, counters, smi))
    kernels = {"paged_attention": paged.paged_attention, "bgmv": bgmv.bgmv,
               "bgmv_expert": bgmv.bgmv_expert, "gmm": gmm.gmm}
    mods = {"paged_attention": paged, "bgmv": bgmv, "bgmv_expert": bgmv,
            "gmm": gmm}
    # the slot engine's configs; the static API's own are phase 10's
    sweep = [sweep_config(torch, ops, ref, counters, flush, kernels, mods,
                          name, smi) for name in sorted(REGISTRY)
             if REGISTRY[name].family in SLOT_FAMILIES]
    print("phase 9 sweep, ms / bound ms by config and plane: " + json.dumps(
        {s["config"]: {p: [[c["kernel"], c["ms"], c["bound_ms"]]
                           for c in v["decode_step"]]
                       for p, v in s["planes"].items()} for s in sweep}),
          flush=True)
    print(f"phase 9: {wall_time() - t0:.1f} s", flush=True)
    return launches


# ------------------------------ phase 10 ----------------------------- #
# (a) the static-batch API on qwen3-moe at depth LAYERS
STATIC_B, STATIC_PROMPT, STATIC_STEPS = 4, 128, 24
SOFTMAX_TOL = 0.05      # int8 vs bf16 KV: the reference's own bound
# int8 vs bf16 KV, the median step's max |logit diff|: twice the sound
# int8 read's reading, below the planted faults' (PERF.md, phase 10)
INT8_LOGIT_TOL = 0.11
# (b) the ssm, hybrid and audio families at full width and depth
NEW_FAMILIES = ("rwkv6-3b", "zamba2-2.7b", "seamless-m4t-large-v2")
# f32 decode_step vs forward over F32_STEPS tokens, held to F32_TOL.
# rwkv6-3b's f32 logits part by more: at its first positions a head's
# state holds one or two keys, its output's variance can fall to the
# order of the per-head group norm's eps (64e-5), and that norm then
# scales the f32 rounding of two sum orders up by as much as
# 1/sqrt(eps) = 40 a layer, over 32 layers. Its algebra is held in f64
# instead (the chunked forward, the recurrent one and the decode at full
# width and depth, held to F64_TOL, ten times the largest reading); its
# f32 readings, chunked and recurrent forward against the decode, are
# held to RWKV_F32_TOL, twice the largest (PERF.md, phase 10)
F32_TOL = 1e-3
RWKV_F32_TOL = 5e-2
F64_TOL = 4e-9
F32_B, F32_STEPS, AUDIO_FRAMES = 2, 32, 1024
FAMILY_B, FAMILY_PROMPT, FAMILY_STEPS = 4, 64, 32


def _clone_cache(torch, cache) -> dict:
    return {k: v.clone() if torch.is_tensor(v) else v
            for k, v in cache.items()}


@contextlib.contextmanager
def shadowed(torch, ops, ref, mod, name, cfg, steps_seen):
    """Every call of ``mod.<name>`` (a static decode step: params, cfg,
    cache, ...) first runs the plain versions on a copy of the cache, then
    the kernels on the cache itself; both logits are compared
    (``step_stats``) and the kernels' result is returned."""
    orig = getattr(mod, name)

    def shadow(params_, cfg_, cache, *rest, **kw):
        with plain_versions(ops, ref):
            lp = orig(params_, cfg_, _clone_cache(torch, cache), *rest,
                      **kw)[0]
        lk, new = orig(params_, cfg_, cache, *rest, **kw)
        rows = torch.zeros(lk.shape[0], dtype=torch.long, device=lk.device)
        steps_seen.append(step_stats(torch, cfg, lk, lp, rows))
        return lk, new

    setattr(mod, name, shadow)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def profile_static(torch, fn, n: int = 3) -> dict:
    """One static decode step (``fn``) under the profiler: host and device
    ms a step, the device's busy share, CUDA launches a step and the top
    kernels by device time."""
    by_name, wall_us = device_profile(torch, fn, n)
    busy_us = sum(t for t, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"wall_ms_per_step": wall_us / 1e3 / n,
            "device_ms_per_step": busy_us / 1e3 / n,
            "device_busy_share": busy_us / wall_us if wall_us else 0.0,
            "cuda_launches_per_step": sum(k for _, k in by_name.values()) / n,
            "top_kernels_ms_per_step": [[name[:60], t / 1e3 / n, k // n]
                                        for name, (t, k) in ranked[:5]]}


def static_lock_step(torch, cfg, runners, tok, steps: int):
    """Step the runners (each ``tok -> logits`` over its own cache) in lock
    step, every one fed the first one's greedy tokens: each step's logits
    against the first's (``step_stats``) and the softmax's max
    difference, a step's entries in the runners' order (runner i's at
    [i - 1 :: len(runners) - 1])."""
    steps_seen, soft = [], []
    rows = torch.zeros(tok.shape[0], dtype=torch.long, device=tok.device)
    V = cfg.vocab_size
    for _ in range(steps):
        lead, *others = [run(tok) for run in runners]
        for lg in others:
            steps_seen.append(step_stats(torch, cfg, lg, lead, rows))
            soft.append((torch.softmax(lg[:, :V], -1)
                         - torch.softmax(lead[:, :V], -1))
                        .abs().max().item())
        tok = torch.argmax(lead[:, :V], dim=-1)[:, None]
    return steps_seen, soft


def _static_runner(step, params, cfg, cache, *rest, route=None):
    """``tok -> logits`` of one static decode step function over ``cache``
    (threaded), routing a ServerPool before each step."""
    state = {"cache": cache}

    def run(tok):
        if route is not None:
            route()
        logits, state["cache"] = step(params, cfg, state["cache"], tok,
                                      *rest)
        return logits
    return run


def static_variant(torch, ops, ref, counters, cfg, engine, prompts, ids,
                   per_step, what: str) -> dict:
    """One variant of the static API: ``Engine.prefill`` then
    ``Engine.decode`` of STATIC_STEPS tokens, counted (counts set to 0
    just before each) and timed; each decode kernel's launches a step held
    to ``per_step`` x layers; then the same again with every step's
    kernels held against the plain versions on the same state, its tokens
    equal to the first run's bit for bit."""
    from repro_torch.core import disagg
    from repro_torch.models import transformer
    from repro_torch.obs.clock import wall_time

    L = cfg.n_layers
    last = prompts[:, -1:]
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = wall_time()
    cache = engine.prefill(prompts)
    torch.cuda.synchronize()
    prefill_s = wall_time() - t0
    pre = {k: fn.launches for k, fn in counters.items()}
    for fn in counters.values():
        fn.launches = 0
    t0 = wall_time()
    toks = engine.decode(cache, last, STATIC_STEPS, adapter_ids=ids)
    torch.cuda.synchronize()
    decode_s = wall_time() - t0
    dec = {k: fn.launches for k, fn in counters.items()}
    for name, n in per_step.items():
        check(dec[name] == n * L * STATIC_STEPS,
              f"{what}: {name} launched {dec[name]} times in "
              f"{STATIC_STEPS} decode steps, not {n} x {L} layers a step")
    others = {k: v for k, v in dec.items() if k not in per_step and v}
    check(not others, f"{what}: unexpected launches {others}")
    check(pre["gmm"] == 3 * (L - 1) and sum(pre.values()) == pre["gmm"],
          f"{what}: prefill launches {pre} (3 gmm a layer, the last "
          f"layer's FFN skipped)")
    out = {"prefill_s": prefill_s, "prefill_launches": {
               k: v for k, v in pre.items() if v},
           "decode_ms_per_step": 1e3 * decode_s / STATIC_STEPS,
           "tokens_per_s": toks.numel() / decode_s,
           "decode_launches": {k: v for k, v in dec.items() if v},
           "launches_per_step": {k: v // STATIC_STEPS
                                 for k, v in dec.items() if v},
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{what}: token out of the vocabulary")
    mod, name = (disagg, "disagg_decode_step") if engine.server is not None \
        else (transformer, "decode_step")
    steps_seen = []
    with shadowed(torch, ops, ref, mod, name, cfg, steps_seen):
        again = engine.decode(engine.prefill(prompts), last, STATIC_STEPS,
                              adapter_ids=ids)
    check(bool((again == toks).all()),
          f"{what}: two runs through the kernels gave different tokens")
    out["kernels_vs_plain"] = hold_steps(steps_seen, f"{what}, kernels vs "
                                         f"plain versions")
    out["profile"] = profile_static(
        torch, lambda: engine.decode(cache, last, 1, adapter_ids=ids))
    out["launches"] = {k: pre[k] + dec[k] for k in counters}
    return out, toks


def static_cell(torch, ops, ref, counters, smi) -> dict:
    """Phase 10(a): the static-batch API (``Engine.prefill`` / ``decode``)
    on qwen3-moe at full width, depth LAYERS: STATIC_B prompts of
    STATIC_PROMPT tokens, STATIC_STEPS greedy steps, adapters of true
    ranks RANKS (one a row) in a rank-32 pool. Variants: coupled on all
    seven targets with bf16 and with int8 KV, coupled on gate/up/down,
    disaggregated through a LoRAServer and through a 2-replica
    ServerPool; each against the plain versions (``static_variant``);
    coupled (gate/up/down) == disaggregated and int8 against bf16 KV in
    lock step."""
    import numpy as np

    from repro_torch.core import disagg
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.obs.clock import wall_time
    from repro_torch.serving.engine import Engine, EngineConfig

    t0 = wall_time()
    dev = "cuda"
    cfg, params = serve.model(ARCH, layers=LAYERS, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (STATIC_B, STATIC_PROMPT)), device=dev)
    ids = np.arange(STATIC_B, dtype=np.int32) % len(RANKS)
    pool7 = serve.adapter_pool(cfg, "coupled", RANKS, seed=SEED,
                               dtype=torch.bfloat16, device=dev)
    two = serve.build_pool(cfg, RANKS, 2, seed=SEED, dtype=torch.bfloat16,
                           device=dev)
    ffn = two["pool"]
    one = serve.build_pool(cfg, RANKS, 1, seed=SEED, dtype=torch.bfloat16,
                           device=dev)["server"].replicas[0]
    # the static API reads no slot layout: the dense one needs no page fit
    ecfg = EngineConfig(max_len=STATIC_PROMPT + STATIC_STEPS + 8,
                        paged=False)
    q8 = dataclasses.replace(ecfg, kv_quant=True)
    coupled7 = {"bgmv": 4, "bgmv_expert": 3, "gmm": 3}
    coupled3 = {"bgmv_expert": 3, "gmm": 3}
    dis = {"bgmv_expert": 2, "gmm": 3}
    # a hook launches once on each replica that homes an active row's
    # adapter: ids 0-3 sit on both of the pool's replicas
    dis2 = {"bgmv_expert": 4, "gmm": 3}
    variants = {
        "coupled_bf16": (Engine(cfg, params, ecfg, pool=pool7, device=dev),
                         coupled7),
        "coupled_int8": (Engine(cfg, params, q8, pool=pool7, device=dev),
                         coupled7),
        "coupled_ffn": (Engine(cfg, params, ecfg, pool=ffn, device=dev),
                        coupled3),
        "disagg_server": (Engine(cfg, params, ecfg, server=one, pool=ffn,
                                 device=dev), dis),
        "disagg_pool2": (Engine(cfg, params, ecfg, server=two["server"],
                                pool=ffn, device=dev), dis2),
    }
    print(f"phase 10(a): {cfg.name} static batch, depth {cfg.n_layers}, "
          f"B={STATIC_B} x {STATIC_PROMPT} prompt tokens, {STATIC_STEPS} "
          f"steps, ranks {RANKS}", flush=True)
    out, launches, toks = {}, {}, {}
    for name, (eng, per_step) in variants.items():
        out[name], toks[name] = static_variant(
            torch, ops, ref, counters, cfg, eng, prompts, ids, per_step,
            f"static {name}")
        launches[f"static_{name}"] = out[name].pop("launches")
        print(f"phase 10(a) {name}: " + json.dumps(out[name]), flush=True)
    # coupled (gate/up/down) == disaggregated, and int8 against bf16 KV, in
    # lock step from one prefill each
    ids_t = torch.as_tensor(ids, device=dev)
    last = prompts[:, -1:]
    e3, ed = variants["coupled_ffn"][0], variants["disagg_server"][0]
    sp = two["server"]
    runs = [_static_runner(transformer.decode_step, params, cfg,
                           e3.prefill(prompts), ffn.lora_ctx(ids_t)),
            _static_runner(disagg.disagg_decode_step, params, cfg,
                           ed.prefill(prompts), one, ids_t, ffn.scale),
            _static_runner(disagg.disagg_decode_step, params, cfg,
                           ed.prefill(prompts), sp, ids_t, ffn.scale,
                           route=lambda: sp.route_step(ids))]
    seen, _ = static_lock_step(torch, cfg, runs, last, STATIC_STEPS)
    sp.route_step(None)
    out["coupled_eq_disagg"] = hold_steps(seen, "static coupled (gate/up/"
                                          "down) == disagg")
    eb, e8 = variants["coupled_bf16"][0], variants["coupled_int8"][0]
    # int8 against bf16 KV, and planted faults of the int8 read that the
    # limit must catch: the prompt's scales dropped (codes read raw) and
    # halved (every prompt key and value read at half its size)
    faults = {"prompt_scales_dropped": lambda c: c.fill_(1.0),
              "prompt_scales_halved": lambda c: c.mul_(0.5)}
    caches = [eb.prefill(prompts)] + [e8.prefill(prompts)
                                      for _ in range(1 + len(faults))]
    for fault, c in zip(faults.values(), caches[2:]):
        fault(c["k_scale"])
        fault(c["v_scale"])
    runs = [_static_runner(transformer.decode_step, params, cfg, c,
                           pool7.lora_ctx(ids_t)) for c in caches]
    seen, soft = static_lock_step(torch, cfg, runs, last, STATIC_STEPS)
    n = len(runs) - 1
    sound = step_summary(seen[::n])
    med = sound["step_logits_max_abs_diff"]["median"]
    check(max(soft[::n]) < SOFTMAX_TOL, f"static int8 vs bf16 KV: a "
          f"step's softmax differs by {max(soft[::n])} >= {SOFTMAX_TOL}")
    check(med <= INT8_LOGIT_TOL, f"static int8 vs bf16 KV: the median "
          f"step's logits differ by {med} > {INT8_LOGIT_TOL}")
    planted = {}
    for i, fault in enumerate(faults, 1):
        fm = step_summary(seen[i::n])["step_logits_max_abs_diff"]["median"]
        check(fm > INT8_LOGIT_TOL, f"static int8 vs bf16 KV: the planted "
              f"fault {fault} reads {fm} <= {INT8_LOGIT_TOL}: the limit "
              f"would not catch it")
        planted[fault] = {"median_step_logits_max_abs_diff": fm,
                          "softmax_max_abs_diff": max(soft[i::n])}
    out["int8_vs_bf16"] = {"softmax_max_abs_diff": max(soft[::n]),
                           "softmax_tol": SOFTMAX_TOL,
                           "logit_tol": INT8_LOGIT_TOL, **sound,
                           "planted_faults": planted}
    out["free_run_tokens_equal"] = {
        "coupled_ffn_vs_disagg_server": int((toks["coupled_ffn"]
                                             == toks["disagg_server"]).sum()),
        "disagg_server_vs_pool2": int((toks["disagg_server"]
                                       == toks["disagg_pool2"]).sum()),
        "int8_vs_bf16": int((toks["coupled_int8"]
                             == toks["coupled_bf16"]).sum()),
        "of": STATIC_B * STATIC_STEPS}
    out["seconds"] = wall_time() - t0
    print("phase 10(a) static API: " + json.dumps(
        {k: out[k] for k in ("coupled_eq_disagg", "int8_vs_bf16",
                             "free_run_tokens_equal", "seconds")})
          + f"; card {smi}", flush=True)
    del variants, params, pool7, two, one, runs, eb, e8, e3, ed
    free_device(torch)
    return launches


@contextlib.contextmanager
def wide_accumulation(torch):
    """The port's f32 accumulations (the ``F32`` of the model modules)
    widened to f64: with f64 weights every operation then runs in f64."""
    from repro_torch.models import cache, layers, ssm
    mods = (cache, layers, ssm)
    for m in mods:
        m.F32 = torch.float64
    try:
        yield
    finally:
        for m in mods:
            m.F32 = torch.float32


def recurrent_forward(torch, ssm, transformer, params, cfg, toks):
    """rwkv6's forward through its recurrent form (chunk 1): the decode's
    arithmetic, but for the GEMMs' row counts."""
    orig = ssm.rwkv6_time_mix
    ssm.rwkv6_time_mix = functools.partial(orig, chunk=1)
    try:
        return transformer.forward(params, cfg, toks)[0]
    finally:
        ssm.rwkv6_time_mix = orig


def rwkv_f64(torch, ssm, transformer, cfg, toks, logits32) -> dict:
    """rwkv6 in f64 at full width and depth: the chunked forward, the
    recurrent forward and ``decode_step`` over the same tokens, each held
    to the decode within F64_TOL; each f32 path (``logits32``) against
    its f64 twin."""
    from repro_torch.models import cache as cache_mod
    from repro_torch.models.model import init_params

    f64 = torch.float64
    with wide_accumulation(torch):
        params = init_params(cfg, seed=SEED, dtype=f64, device="cuda")
        got = {"forward": transformer.forward(params, cfg, toks)[0],
               "recurrent_forward": recurrent_forward(
                   torch, ssm, transformer, params, cfg, toks)}
        cache = cache_mod.init_cache(cfg, toks.shape[0], toks.shape[1],
                                     dtype=f64, device="cuda")
        steps = []
        for t in range(toks.shape[1]):
            lg, cache = transformer.decode_step(params, cfg, cache,
                                                toks[:, t:t + 1])
            steps.append(lg)
        got["decode"] = torch.stack(steps, 1)
    check(all(v.dtype == f64 for v in got.values()),
          f"{cfg.name} f64: logits not f64")
    out = {"tol": F64_TOL}
    for what in ("forward", "recurrent_forward"):
        d = (got[what] - got["decode"]).abs().max().item()
        check(d <= F64_TOL, f"{cfg.name} f64: {what} vs decode_step max "
              f"|logit diff| {d} > {F64_TOL}")
        out[f"{what}_vs_decode"] = d
    out["f32_vs_f64"] = {k: (v.double() - got[k]).abs().max().item()
                         for k, v in logits32.items()}
    del params, cache, steps, got
    free_device(torch)
    return out


def family_cell(torch, name: str, smi) -> dict:
    """Phase 10(b), one of the ssm, hybrid and audio configs at its
    published widths and depth. f32
    weights: ``decode_step`` over F32_STEPS positions of F32_B rows against
    one ``forward`` over the same tokens (seamless: cross caches from a
    forward over AUDIO_FRAMES frames), held to F32_TOL; rwkv6 also
    through its recurrent forward, held to RWKV_F32_TOL, and all three in
    f64 (``rwkv_f64``), held to F64_TOL. bf16 weights:
    ``Engine.prefill`` of FAMILY_B prompts of FAMILY_PROMPT tokens and
    ``Engine.decode`` of FAMILY_STEPS steps (seamless: the cross caches of
    a forward over AUDIO_FRAMES frames filled in between, the reference's
    way to serve the encoder), twice, the tokens bit for bit."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import cache as cache_mod
    from repro_torch.models import ssm, transformer
    from repro_torch.models.model import init_params
    from repro_torch.obs.clock import wall_time
    from repro_torch.serving.engine import Engine, EngineConfig

    t0 = wall_time()
    dev, cfg = "cuda", get_config(name)
    rng = np.random.default_rng(SEED)
    audio = cfg.family == "audio"
    out = {"config": name, "family": cfg.family, "layers": cfg.n_layers,
           "d": cfg.d_model, "params_b": cfg.param_count() / 1e9}

    def frames(B, dtype):
        return torch.as_tensor(rng.standard_normal(
            (B, AUDIO_FRAMES, cfg.d_model)) * 0.1, dtype=dtype, device=dev)

    def fill_cross(cache, fe, params):
        _, (_, (ck, cv)) = transformer.forward(
            params, cfg, torch.zeros((fe.shape[0], 1), dtype=torch.long,
                                     device=dev), frontend_emb=fe,
            collect_kv=True)
        cache["ck"][:, :, :AUDIO_FRAMES] = ck.to(cache["ck"].dtype)
        cache["cv"][:, :, :AUDIO_FRAMES] = cv.to(cache["cv"].dtype)
        cache["cross_len"] = AUDIO_FRAMES

    # f32: decode_step against forward
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=SEED, dtype=torch.float32, device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (F32_B, F32_STEPS)), device=dev)
    fe = frames(F32_B, torch.float32) if audio else None
    fwd, aux = transformer.forward(params, cfg, toks, frontend_emb=fe,
                                   collect_kv=audio)
    cache = cache_mod.init_cache(cfg, F32_B, F32_STEPS, dtype=torch.float32,
                                 device=dev)
    if audio:
        ck, cv = aux[1]
        cache["ck"][:, :, :AUDIO_FRAMES] = ck.float()
        cache["cv"][:, :, :AUDIO_FRAMES] = cv.float()
        cache["cross_len"] = AUDIO_FRAMES
    steps = []
    for t in range(F32_STEPS):
        lg, cache = transformer.decode_step(params, cfg, cache,
                                            toks[:, t:t + 1])
        steps.append(lg)
    dec = torch.stack(steps, 1)
    by_pos = (dec - fwd).abs().amax(dim=(0, 2))
    rwkv = cfg.family == "ssm"
    diff, tol = by_pos.max().item(), RWKV_F32_TOL if rwkv else F32_TOL
    check(bool(torch.isfinite(dec).all()) and diff <= tol,
          f"{name} f32: decode_step vs forward max |logit diff| {diff} > "
          f"{tol}")
    out["f32"] = {"decode_vs_forward_max_abs_logit_diff": diff,
                  "first_positions": by_pos[:5].tolist(),
                  "after_position_4": by_pos[5:].max().item(),
                  "tol": tol, "max_abs_logit": fwd.abs().max().item(),
                  "greedy_equal": int((dec.argmax(-1) == fwd.argmax(-1))
                                      .sum()),
                  "of": F32_B * F32_STEPS,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if rwkv:
        logits32 = {"forward": fwd, "decode": dec,
                    "recurrent_forward": recurrent_forward(
                        torch, ssm, transformer, params, cfg, toks)}
        rec = (logits32["recurrent_forward"] - dec).abs().max().item()
        check(rec <= tol, f"{name} f32: the recurrent forward vs "
              f"decode_step max |logit diff| {rec} > {tol}")
        out["f32"]["recurrent_forward_vs_decode"] = rec
    del params, cache, steps
    free_device(torch)
    if rwkv:
        out["f64"] = rwkv_f64(torch, ssm, transformer, cfg, toks, logits32)
        del logits32
    del fwd, dec, aux

    # bf16: the static engine, twice
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=SEED, device=dev)
    eng = Engine(cfg, params, EngineConfig(
        max_len=FAMILY_PROMPT + FAMILY_STEPS, paged=False), device=dev)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (FAMILY_B, FAMILY_PROMPT)), device=dev)
    fe = frames(FAMILY_B, torch.bfloat16) if audio else None
    runs = []
    for _ in range(2):
        t1 = wall_time()
        cache = eng.prefill(prompts)
        if audio:
            fill_cross(cache, fe, params)
        torch.cuda.synchronize()
        t2 = wall_time()
        got = eng.decode(cache, prompts[:, -1:], FAMILY_STEPS)
        torch.cuda.synchronize()
        t3 = wall_time()
        runs.append((got, t2 - t1, t3 - t2))
    out["profile"] = profile_static(
        torch, lambda: eng.decode(cache, prompts[:, -1:], 1))
    (a, pre_s, dec_s), (b, _, _) = runs
    check(bool((a == b).all()), f"{name} bf16: two runs gave different "
          f"tokens")
    check(bool(((a >= 0) & (a < cfg.vocab_size)).all()),
          f"{name} bf16: token out of the vocabulary")
    out["bf16"] = {"prefill_s": [r[1] for r in runs],
                   "decode_ms_per_step": [1e3 * r[2] / FAMILY_STEPS
                                          for r in runs],
                   "tokens_per_s": [a.numel() / r[2] for r in runs],
                   "tokens_equal_twice": True,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    out["seconds"] = wall_time() - t0
    print("phase 10(b) " + json.dumps(out) + f"; card {smi}", flush=True)
    del params, eng, cache, runs
    free_device(torch)
    return out


def static_phase(torch, ops, ref, counters, smi) -> dict:
    """Phase 10: the static-batch API and the families only it serves."""
    from repro_torch.obs.clock import wall_time

    t0 = wall_time()
    launches = static_cell(torch, ops, ref, counters, smi)
    fams = [family_cell(torch, name, smi) for name in NEW_FAMILIES]
    print("phase 10(b) summary: " + json.dumps({
        f["config"]: {"f32_diff": f["f32"][
            "decode_vs_forward_max_abs_logit_diff"],
            "bf16_ms_per_step": f["bf16"]["decode_ms_per_step"][-1],
            "peak_gib": f["bf16"]["peak_gib"],
            "device_busy_share": f["profile"]["device_busy_share"]}
        for f in fams}), flush=True)
    print(f"phase 10: {wall_time() - t0:.1f} s", flush=True)
    return launches


# ------------------------------ phase 11 ----------------------------- #
MESH = (2, 1)                  # the main path's grid: experts over "data"
MESH_GRIDS = ((4, 1), (2, 2))  # 11(b), at depth CHECK_LAYERS
SERVER_GRIDS = ((2, 1), (1, 2), (2, 2))    # 11(c), (ep, pp)
HOOK_ROWS_A_EXPERT = 64        # 11(c): 8192 hook rows at 128 experts
HOOK_TOKENS = 8                # 11(c): 8 tokens top-8, 64 active rows


def mesh_cards(torch) -> dict:
    """What every line of phase 11 prints of the machine: the visible
    cards, the grid's devices (cuda:0, cuda:1 where two cards are visible,
    else cuda:0 twice) and whether the two cards reach each other's memory
    (a copy without peer access goes through the host)."""
    n = torch.cuda.device_count()
    devs = [torch.device("cuda", i) for i in range(min(n, 2))]
    if len(devs) < 2:
        devs = devs * 2
    peer = torch.cuda.can_device_access_peer(0, 1) if n >= 2 else None
    return {"cards": n, "grid": [str(d) for d in devs],
            "peer_access": peer, "devices": devs}


def mesh_ctx_of(cfg, shape, devs):
    """The expert-parallel ctx of a ``shape`` grid over ``devs`` (cycled
    over its positions)."""
    from repro_torch.distributed import steps
    from repro_torch.launch.mesh import make_serve_mesh
    n = shape[0] * shape[1]
    return steps.expert_parallel_ctx(
        make_serve_mesh(*shape, devices=[devs[i % len(devs)]
                                         for i in range(n)]), cfg)


def mesh_print(what: str, out: dict, head: dict, smi: str) -> None:
    print(f"phase 11{what}: " + json.dumps(
        {**{k: head[k] for k in ("cards", "grid", "peer_access")}, **out})
        + f"; card {smi}", flush=True)


def mesh_gmm_hold(torch, ops, ref, cfg, ecfg, params, sharded) -> dict:
    """11(a): the mesh's block ``gmm`` launches at the main path's own
    shapes, after its counted runs. ``moe.expert_gmm`` over layer 0's
    gate, up and down blocks (on the grid's devices) at the decode
    dispatch (6 rows, dropless C) and at one prefill chunk, each held
    bit for bit to one ``ops.gmm`` over all E experts and within GMM_TOL
    of the plain version (rows past their group size are zero)."""
    from repro_torch.models import moe

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 111)
    E, K = cfg.n_experts, cfg.top_k
    out, worst = {}, 0.0
    for label, T in (("decode", 6), ("prefill_chunk", ecfg.prefill_chunk)):
        C = moe.capacity(T, K, E, cfg.capacity_factor,
                         dropless=T * K <= 4096)
        picks = torch.stack([torch.randperm(E, generator=g, device=dev)[:K]
                             for _ in range(T)]).reshape(-1)
        sizes = torch.bincount(picks, minlength=E).to(torch.int32)
        live = (torch.arange(C, device=dev)[None, :]
                < sizes[:, None])[..., None]
        out[label] = {"tokens": T, "C": C}
        for name in ("gate", "up", "down"):
            whole = params["layers"]["moe"][name][0]
            blocks = sharded["layers"]["moe"][name][0]
            xe = torch.randn(E, C, whole.shape[1], generator=g, device=dev)
            xe = torch.where(live, xe, 0.0).bfloat16()
            got = moe.expert_gmm(xe, blocks, sizes)
            one = ops.gmm(xe, whole, sizes)
            want = ref.gmm_ref(xe, whole, sizes)
            torch.cuda.synchronize()
            check(bool(torch.equal(got, one)), f"11(a) {label} {name}: the "
                  f"blocks' gmm differs from one launch over {E} experts")
            err = (got - want).abs().max().item()
            check(err <= GMM_TOL, f"11(a) {label} {name}: blocks' gmm max "
                  f"abs err {err} > {GMM_TOL}")
            out[label][name] = err
            worst = max(worst, err)
            del xe, got, one, want
    out["equal_one_launch"] = True
    out["max_abs_err"] = worst
    out["block_devices"] = [str(b.device) for b in
                            sharded["layers"]["moe"]["up"].blocks]
    return out


def mesh_main_path(torch, ops, ref, counters, cfg, params, ecfg,
                   head) -> tuple:
    """11(a): the main path under a (2, 1) mesh at the serving cell, a
    pool of 2 replicas built partitioned, host and fused planes through
    the engine, against the same engine without a mesh (a duplicated
    pool): tokens bit for bit, one dispatch a fused step, each capture 2 x
    3 gmm, 2 bgmv_expert and 1 paged_attention a layer; ms/step, graph
    pool and server pool bytes; then the block launches held alone
    (``mesh_gmm_hold``). Returns (the record, the mesh fused run's
    launches, counts set to 0 just before it)."""
    from repro_torch.distributed import steps
    from repro_torch.launch import serve

    traffic = serve.Traffic(adapter_ranks=RANKS)
    requests = serve.make_requests(cfg, traffic, SEED)
    L = cfg.n_layers
    ctx = mesh_ctx_of(cfg, MESH, head["devices"])
    sharded = steps.shard_serve_params(params, ctx)
    per_step = {"gmm": 3 * ctx.size * L, "bgmv_expert": 2 * L,
                "paged_attention": L}
    planes, pool_bytes, out = {}, {}, {}
    launches = {name: 0 for name in counters}
    for mesh in (False, True):
        lora = serve.build_pool(cfg, RANKS, 2, seed=SEED,
                                dtype=torch.bfloat16, device="cuda",
                                partition_slots=mesh)
        sp = lora["server"]
        pool_bytes["partitioned" if mesh else "duplicated"] = {
            "slots_a_replica": [r.M for r in sp.replicas],
            "bytes": sum(r.cache_bytes() for r in sp.replicas)}
        for tr in ("host", "fused"):
            key = ("mesh " if mesh else "") + tr
            for fn in counters.values():
                fn.launches = 0
            _, planes[key] = plane_runs(
                torch, ops, cfg, sharded if mesh else params, ecfg, lora,
                tr, requests, traffic, TIMED_RUNS + 1,
                mesh_ctx=ctx if mesh else None)
            if mesh and tr == "fused":
                launches.update(planes[key]["runs"][0]["launches"])
        del lora, sp
        free_device(torch)
    want = planes["host"]["runs"][0]["tokens"]
    held = check_planes(cfg, planes["host"], planes["fused"], "11(a) "
                        "no mesh", {**per_step, "gmm": 3 * L}, 2)
    held = check_planes(cfg, planes["mesh host"], planes["mesh fused"],
                        "11(a) mesh", per_step, 2, blocks=ctx.size)
    for run in planes["mesh host"]["runs"]:
        check(run["tokens"] == want, "11(a): the mesh's tokens differ from "
              "the engine's without a mesh")
    first = planes["mesh host"]["runs"][0]
    steps_n = first["decode_steps"]
    host_run = dict(first["launches"])
    # the prefill chunks' gmm: 3 a block a layer but the last
    host_run["gmm"] = host_run.get("gmm", 0) - \
        3 * ctx.size * (L - 1) * first["prefill_chunks"]
    out.update({
        "tokens_equal_no_mesh": True, "held": held,
        "expert_blocks": ctx.size, "block_devices": [str(d) for d in
                                                     ctx.devices],
        "per_fused_step": per_step,
        "host_plane_per_step": {n: host_run.get(n, 0) / steps_n for n in
                                ("gmm", "bgmv_expert", "paged_attention")},
        "decode_ms_per_step": {k: summary(v)["decode_ms_per_step"]
                               for k, v in planes.items()},
        "decode_ms_per_step_mean": {
            k: statistics.mean(summary(v)["decode_ms_per_step"])
            for k, v in planes.items()},
        "fused_stats": {k: planes[k]["stats_first_run"] for k in planes
                        if k.endswith("fused")},
        "graph_pool_bytes": {k: sum(c["pool_bytes_added"]
                                    for c in planes[k]["captures"])
                             for k in planes if k.endswith("fused")},
        "server_pool": pool_bytes,
        "expert_gmm_held": mesh_gmm_hold(torch, ops, ref, cfg, ecfg, params,
                                         sharded)})
    return out, launches


def mesh_grids(torch, ops, cfg, params, ecfg, head) -> dict:
    """11(b): grids (4, 1) and (2, 2) at depth CHECK_LAYERS, fused: the
    tokens of the engine without a mesh."""
    from repro_torch.distributed import steps
    from repro_torch.launch import serve

    traffic = serve.Traffic(adapter_ranks=RANKS)
    requests = serve.make_requests(cfg, traffic, SEED)
    cfg2 = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    params2 = dict(params, layers=_first_layers(params["layers"],
                                                CHECK_LAYERS))
    out, base = {}, None
    for shape in (None,) + MESH_GRIDS:
        ctx = None if shape is None else mesh_ctx_of(cfg2, shape,
                                                     head["devices"])
        lora = serve.build_pool(cfg2, RANKS, 2, seed=SEED,
                                dtype=torch.bfloat16, device="cuda",
                                partition_slots=shape is not None)
        p = params2 if ctx is None else steps.shard_serve_params(params2,
                                                                  ctx)
        _, run = plane_runs(torch, ops, cfg2, p, ecfg, lora, "fused",
                            requests, traffic, 1, mesh_ctx=ctx)
        toks = run["runs"][0]["tokens"]
        if shape is None:
            base = toks
            continue
        check(toks == base, f"11(b) {shape}: tokens differ from the "
              f"engine's without a mesh")
        out[str(shape)] = {"expert_blocks": ctx.size,
                           "block_devices": [str(d) for d in ctx.devices],
                           "tokens_equal_no_mesh": True,
                           "captures": [c["launches"]
                                        for c in run["captures"]]}
        del lora
        free_device(torch)
    return out


def hook_rows(torch, cfg):
    """11(c)'s rows at the hooks' full-width shapes: E * 64 dispatch rows,
    expert-major; 8 tokens each routed to top_k distinct experts (64
    active rows), token t on adapter t % 4; the other rows -1."""
    E, C = cfg.n_experts, HOOK_ROWS_A_EXPERT
    g = torch.Generator().manual_seed(SEED + 11)
    ids = torch.full((E * C,), -1, dtype=torch.int32)
    fill = [0] * E
    for t in range(HOOK_TOKENS):
        for e in torch.randperm(E, generator=g)[:cfg.top_k].tolist():
            ids[e * C + fill[e]] = t % len(RANKS)
            fill[e] += 1
    eids = torch.arange(E * C, dtype=torch.int32) // C
    rows = {hook: torch.randn((E * C, d), generator=g).to(torch.bfloat16)
            .cuda() for hook, d in (("up", cfg.d_model),
                                    ("down", cfg.d_ff))}
    return rows, ids.cuda(), eids.cuda()


def server_mesh_cell(torch, flush, cfg, head) -> dict:
    """11(c): the EP x PP LoRA Server at (x, y) in SERVER_GRIDS, adapters
    of true ranks RANKS in a rank-32 pool at depth LAYERS: each hook of
    every layer torch.equal to the flat server's, x bgmv_expert launches a
    hook, and its time beside the flat server's (layer 0)."""
    from repro_torch.core.lora_server import (LoRAServer, ServerConfig,
                                              make_server_mesh,
                                              pool_tensors_from_adapter)
    from repro_torch.kernels import bgmv
    from repro_torch.launch import serve

    pool = serve.adapter_pool(cfg, "disagg", RANKS, seed=SEED,
                              dtype=torch.bfloat16, device="cuda")
    rows, ids, eids = hook_rows(torch, cfg)

    def server(x, y, mesh=None):
        srv = LoRAServer(cfg, ServerConfig(m=x * y, x=x, y=y,
                                           cache_slots=len(RANKS),
                                           rank=pool.rank),
                         dtype=torch.bfloat16, device="cuda", mesh=mesh)
        for a in range(len(RANKS)):
            srv.insert(a, pool_tensors_from_adapter(pool, a),
                       rank=pool.rank_of(a))
        return srv

    flat = server(1, 1)
    out = {"rows": int(ids.numel()), "active_rows": int((ids >= 0).sum()),
           "pool_rank": pool.rank, "true_ranks": list(RANKS),
           "flat_ms": {h: cuda_ms(torch, lambda h=h: flat.compute(
               h, 0, rows[h], ids, eids), flush) for h in rows}}
    for x, y in SERVER_GRIDS:
        devs = head["devices"]
        srv = server(x, y, make_server_mesh(
            x, y, [devs[i % len(devs)] for i in range(x * y)]))
        for hook in rows:
            for layer in range(cfg.n_layers):
                before = bgmv.bgmv_expert.launches
                got = srv.compute(hook, layer, rows[hook], ids, eids)
                check(bgmv.bgmv_expert.launches - before == x,
                      f"11(c) ({x}, {y}): not {x} launches a hook")
                check(torch.equal(got, flat.compute(hook, layer,
                                                    rows[hook], ids, eids)),
                      f"11(c) ({x}, {y}) {hook} hook, layer {layer}: "
                      f"differs from the flat server")
        out[f"({x}, {y})"] = {
            "equal_flat": True, "launches_a_hook": x,
            "placement": srv.placement().describe(),
            "ms": {h: cuda_ms(torch, lambda h=h: srv.compute(
                h, 0, rows[h], ids, eids), flush) for h in rows}}
        del srv
        free_device(torch)
    return out


def mesh_front_door(torch, cfg, params, want_fused, head) -> dict:
    """11(d): the front door with mesh_shape=(2, 1), which takes distinct
    cards: on one card it raises "needs 2 devices"; on two the fused and
    the host plane serve phase 7's main path tokens."""
    from repro_torch.launch import serve

    traffic = serve.Traffic(adapter_ranks=RANKS)
    requests = serve.make_requests(cfg, traffic, SEED)
    pool = serve.adapter_pool(cfg, "disagg", RANKS, seed=SEED,
                              dtype=torch.bfloat16, device="cuda")
    if head["cards"] < 2:
        try:
            front_door(serve, params, pool, traffic, transport="fused",
                       mesh_shape=MESH)
        except ValueError as e:
            check("needs 2 devices" in str(e), f"11(d): {e}")
            return {"one_card": True, "refused": str(e)}
        check(False, "11(d): a (2, 1) mesh was built on one card")
    out = {"one_card": False}
    for tr in ("fused", "host"):
        system = front_door(serve, params, pool, traffic, transport=tr,
                            mesh_shape=MESH)
        res = serve.serve_system(system, requests, traffic)
        check(res["tokens"] == want_fused, f"11(d) {tr}: the tokens under "
              f"the mesh differ from phase 7's")
        out[tr] = {"rounds": res["rounds"],
                   "wall_ms_per_round": res["wall_ms_per_round"],
                   "transport_stats": res["transport_stats"]}
        del system
        free_device(torch)
    out["tokens_equal_phase7"] = True
    return out


def mesh_phase(torch, ops, ref, counters, flush, smi, cfg, params, ecfg,
               want_fused) -> dict:
    """Phase 11: the mesh-sharded serving plane (11(a)-(d)). Returns the
    launches of the mesh's main path run (11(a), fused)."""
    from repro_torch.obs.clock import wall_time

    t0 = wall_time()
    head = mesh_cards(torch)
    a, launches = mesh_main_path(torch, ops, ref, counters, cfg, params,
                                 ecfg, head)
    mesh_print("(a) main path under a (2, 1) mesh", a, head, smi)
    mesh_print("(b) grids at depth 2", mesh_grids(torch, ops, cfg, params,
                                                   ecfg, head), head, smi)
    mesh_print("(c) EP x PP LoRA Server", server_mesh_cell(
        torch, flush, cfg, head), head, smi)
    mesh_print("(d) front door", mesh_front_door(torch, cfg, params,
                                                 want_fused, head),
               head, smi)
    free_device(torch)
    print(f"phase 11: {wall_time() - t0:.1f} s", flush=True)
    return launches


# ------------------------------ phase 12 ----------------------------- #
# (i) the three kernels' autograd at the fine-tune's shapes; (ii) path (a),
# the LoRA fine-tune at the serving cell's width and depth; (iii) path (b),
# full-parameter training of smollm-360m with a resume; (iv) the adapter of
# (ii) served through the front door on both planes
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_WARM = 4, 1024, 20, 3
TRAIN_RANK, TRAIN_ALPHA = 8, 16.0
# (iii): 6 steps with a checkpoint at 3, then the 3 resumed (20 + 10
# took 186 s; cut to 10 + 5 to make room for phase 13, to 6 + 3 for
# phase 14)
FULL_ARCH, FULL_B, FULL_S, FULL_STEPS, FULL_CKPT = "smollm-360m", 8, 4096, \
    6, 3
# the kernels' gradients against the twins' (relative to the largest
# magnitude of the twin's): f32 ones (dA, dB, and dx before its cast) sum
# in another order; a bf16 one (dx of bf16 activations, gmm's bf16
# products of the bf16-rounded dy) parts by a rounding or two
GRAD_TOL = 1e-4
GRAD_BF16_TOL = 2 ** -7
# path (a)'s first step, kernels vs twins through 4 bf16 layers of top-8
# routing: the loss, and each adapter gradient's norm
STEP_LOSS_TOL = 1e-3
STEP_NORM_TOL = 1e-2
SERVE_TOKENS = 16
FFN_TARGETS = ("gate", "up", "down")


def train_dispatch(torch, g, T, E, K, C):
    """The dispatch of T tokens routed top-K of E experts (distinct, drawn
    uniformly) at capacity C: (row adapter (E*C,) int32, 0 at a row that
    holds a token and -1 at a pad row; expert per row; group sizes (E,)
    int32; live rows (E, C) bool)."""
    dev = torch.device("cuda")
    picks = torch.rand(T, E, generator=g, device=dev).argsort(dim=1)[:, :K]
    sizes = torch.bincount(picks.reshape(-1), minlength=E).clamp(max=C)
    live = torch.arange(C, device=dev)[None, :] < sizes[:, None]
    ids = torch.where(live, 0, -1).reshape(-1).to(torch.int32)
    eids = (torch.arange(E * C, device=dev) // C).to(torch.int32)
    return ids, eids, sizes.to(torch.int32), live


def _rel_errs(torch, got, want):
    return [((a.float() - b.float()).abs().max()
             / b.float().abs().max().clamp_min(1e-30)).item()
            for a, b in zip(got, want)]


def autograd_case(torch, flush, name, kernel, twin, leaves, dy, bf16_grads,
                  n_bytes, n_ops, ops_rate):
    """One kernel's forward + backward (``kernel``, through its autograd
    Function) against torch autograd of its plain twin on the same card:
    the forward and each gradient within GRAD_TOL (GRAD_BF16_TOL where
    ``bf16_grads``), both timed (CUDA events, L2 flushed), beside the
    least time of the function (``n_bytes`` over the memory rate,
    ``n_ops`` over ``ops_rate``)."""
    def run(fn, ls):
        y = fn(*ls)
        return (y,) + torch.autograd.grad(y, ls, dy)

    twin_leaves = [t.detach().clone().requires_grad_() for t in leaves]
    got, want = run(kernel, leaves), run(twin, twin_leaves)
    torch.cuda.synchronize()
    errs = _rel_errs(torch, got, want)
    names = ["forward"] + [f"d{i}" for i in range(len(leaves))]
    for n, e, t, bf in zip(names, errs, got, [False] + list(bf16_grads)):
        tol = GRAD_BF16_TOL if bf else GRAD_TOL
        check(e <= tol, f"train {name}: {n} relative err {e} > {tol}")
    check(all(a.dtype == b.dtype for a, b in zip(got[1:], leaves)),
          f"train {name}: a gradient's dtype is not its operand's")
    ms = cuda_ms(torch, lambda: run(kernel, leaves), flush, n=10, warmup=2)
    plain = cuda_ms(torch, lambda: run(twin, twin_leaves), flush, n=10,
                    warmup=2)
    from repro_torch.analysis import roofline
    t_bytes, t_ops = n_bytes / roofline.HBM_BW, n_ops / ops_rate
    out = {"fwd_bwd_ms": ms, "plain_fwd_bwd_ms": plain,
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "rel_err": dict(zip(names, errs))}
    print(f"train {name}: fwd+bwd kernel {ms:.4f} ms twin {plain:.4f} ms "
          f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}), rel errs "
          + ", ".join(f"{n} {e:.2g}" for n, e in zip(names, errs)),
          flush=True)
    return out


def train_kernels(torch, ops, ref, flush) -> dict:
    """Phase 12(i): ``ops.bgmv`` at T = 4096 rows at the q/k/v/o widths,
    ``ops.bgmv_expert`` at the gate/up/down hooks and ``ops.gmm`` at the
    base GEMMs of path (a)'s dispatch (4096 tokens top-8 of 128 experts at
    capacity 1.25: E*C rows), bf16 activations, f32 rank-8 factors, bf16
    expert weights, each under autograd against its twin's."""
    from repro_torch.analysis import roofline
    from repro_torch.models.moe import capacity
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 12)
    T, r, E, K, d, ff = TRAIN_B * TRAIN_S, TRAIN_RANK, 128, 8, 4096, 1536
    f32, bf16 = torch.float32, torch.bfloat16

    def leaf(shape, dtype, scale):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            dtype).requires_grad_()

    out = {"bgmv": {}, "bgmv_expert": {}, "gmm": {}}
    ids = torch.zeros(T, dtype=torch.int32, device=dev)
    for tgt, d_in, d_out in (("q", d, 8192), ("k", d, 512), ("v", d, 512),
                             ("o", 8192, d)):
        x, A, B = leaf((T, d_in), bf16, 1.0), leaf((1, d_in, r), f32,
                                                   1.0 / r), \
            leaf((1, r, d_out), f32, 0.01)
        dy = torch.randn(T, d_out, generator=g, device=dev) * 1e-2
        n_bytes = T * d_in * 2 * 2 + T * d_out * 4 * 2 + T * 4 \
            + (d_in + d_out) * r * 4 * 2
        out["bgmv"][tgt] = autograd_case(
            torch, flush, f"bgmv {tgt}",
            lambda x, A, B: ops.bgmv(x, A, B, ids),
            lambda x, A, B: ref.bgmv_ref(x, A, B, ids), [x, A, B], dy,
            (True, False, False), n_bytes, 6 * T * r * (d_in + d_out),
            F32_OPS_PER_S)
        del x, A, B, dy
    C = capacity(T, K, E, 1.25)
    row_ids, eids, sizes, live = train_dispatch(torch, g, T, E, K, C)
    n_act, n_used = int(sizes.sum()), int((sizes > 0).sum())
    for tgt, d_in, d_out in (("gate", d, ff), ("up", d, ff),
                             ("down", ff, d)):
        x = leaf((E * C, d_in), bf16, 1.0)
        A, B = leaf((1, E, d_in, r), f32, 1.0 / r), leaf((1, E, r, d_out),
                                                         f32, 0.01)
        dy = torch.randn(E * C, d_out, generator=g, device=dev) * 1e-2
        n_bytes = n_act * (d_in * 2 + d_out * 4) + E * C * (d_out * 4
                                                            + d_in * 2) \
            + E * C * 8 + n_used * (d_in + d_out) * r * 4 * 2
        out["bgmv_expert"][tgt] = autograd_case(
            torch, flush, f"bgmv_expert {tgt} ({E * C} rows, {n_act} active)",
            lambda x, A, B: ops.bgmv_expert(x, A, B, row_ids, eids),
            lambda x, A, B: ref.bgmv_expert_ref(x, A, B, row_ids, eids),
            [x, A, B], dy, (True, False, False), n_bytes,
            6 * n_act * r * (d_in + d_out), F32_OPS_PER_S)
        del x, A, B, dy
    for tgt, d_in, d_out in (("gate", d, ff), ("up", d, ff),
                             ("down", ff, d)):
        xe = (torch.randn(E, C, d_in, generator=g, device=dev)
              * live[..., None]).to(bf16).requires_grad_()
        w = leaf((E, d_in, d_out), bf16, d_in ** -0.5)
        dy = torch.randn(E, C, d_out, generator=g, device=dev) * 1e-2
        n_bytes = n_act * (d_in * 2 + d_out * 4) + E * C * (d_out * 4
                                                            + d_in * 2) \
            + n_used * d_in * d_out * 2 * 2 + E * 4
        out["gmm"][tgt] = autograd_case(
            torch, flush, f"gmm {tgt} (C {C})",
            lambda xe, w: ops.gmm(xe, w, sizes),
            lambda xe, w: ref.gmm_ref(xe, w, sizes), [xe, w], dy,
            (True, True), n_bytes, 6 * n_act * d_in * d_out,
            roofline.PEAK_FLOPS)
        del xe, w, dy
    for row in out.values():
        row["shapes"] = {"T": T, "r": r, "E": E, "C": C, "rows": E * C,
                         "active_rows": n_act}
    return out


def step_profile(torch, fn) -> dict:
    """One training step ``fn`` under torch.profiler, after one outside
    it: wall and device ms, the device's busy share and the 12 kernels of
    most device time (ms, launches)."""
    by_name, wall_us = device_profile(torch, fn, 1)
    dev_us = sum(t for t, _ in by_name.values())
    # kernels whose names share their first 90 characters are summed
    short = {}
    for name, (t, k) in by_name.items():
        t0, k0 = short.get(name[:90], (0.0, 0))
        short[name[:90]] = (t0 + t, k0 + k)
    top = sorted(short.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall_us / 1e3, "device_ms": dev_us / 1e3,
            "device_busy_share": dev_us / wall_us,
            "top_kernels": {name: [t / 1e3, k] for name, (t, k) in top}}


def grad_norms(torch, grads) -> dict:
    from repro_torch.training.tree import flatten_with_keys
    return {k: v.float().norm().item()
            for k, v in flatten_with_keys(grads).items()}


def lora_finetune(torch, ops, ref, counters, smi):
    """Phase 12(ii): ``python -m repro_torch.launch.train --lora`` (its
    ``run``) at the serving cell's width and depth, bf16 base, a rank-8
    f32 adapter on all seven targets, B 4 x S 1024, 20 steps, counts set
    to 0 just before; one more step profiled; then the first step's loss
    and adapter gradients on one state through the kernels and through
    the twins. Returns (the summary, the run's record, its launch
    counts)."""
    from repro_torch.launch import train
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_lora_loss, \
        make_lora_train_step, value_and_grad

    argv = ["--arch", ARCH, "--layers", str(LAYERS), "--dtype", "bfloat16",
            "--lora", "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
            "--steps", str(TRAIN_STEPS), "--lr", "1e-3", "--log-every", "5"]
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rec = train.run(argv)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [rec["losses"][s] for s in range(TRAIN_STEPS)]
    check(all(math.isfinite(v) for v in losses), f"fine-tune: {losses}")
    check(losses[-1] < losses[0], f"fine-tune: the loss did not fall "
          f"({losses[0]} -> {losses[-1]})")
    for name in ("bgmv", "bgmv_expert", "gmm"):
        check(launches[name] > 0, f"fine-tune: {name} never launched")
    warm = [rec["step_s"][s] for s in range(TRAIN_WARM, TRAIN_STEPS)]
    ms = 1e3 * statistics.median(warm)
    args = train.parser().parse_args(argv)
    step = make_lora_train_step(rec["cfg"], rec["params"], rec["scale"],
                                AdamWConfig(lr=args.lr, warmup_steps=10,
                                            total_steps=args.steps))
    last = train_batch(torch, rec["cfg"], TRAIN_B, TRAIN_S, TRAIN_STEPS)
    prof = step_profile(torch, lambda: step(
        rec["adapter"], rec["opt_state"], None, last)[0].item())
    # the first step's loss and gradients on one state, kernels and twins
    adapter0, scale = train.build_adapter(rec["cfg"], args)
    batch = train_batch(torch, rec["cfg"], TRAIN_B, TRAIN_S, 0)
    loss_fn = make_lora_loss(rec["cfg"], rec["params"], scale)
    lk, gk = value_and_grad(loss_fn, adapter0, batch)
    nk = grad_norms(torch, gk)
    del gk
    free_device(torch)
    with plain_versions(ops, ref):
        lt, gt = value_and_grad(loss_fn, adapter0, batch)
    nt = grad_norms(torch, gt)
    del gt
    free_device(torch)
    lk, lt = lk.item(), lt.item()
    check(abs(lk - lt) <= STEP_LOSS_TOL * abs(lt), f"fine-tune step 0: "
          f"loss {lk} with the kernels, {lt} with the twins")
    check(abs(lk - losses[0]) <= STEP_LOSS_TOL * abs(lk),
          f"fine-tune step 0: {lk} here, {losses[0]} in the run")
    norm_err = {k: abs(nk[k] - nt[k]) / max(nt[k], 1e-30) for k in nk}
    worst = max(norm_err, key=norm_err.get)
    check(norm_err[worst] <= STEP_NORM_TOL, f"fine-tune step 0: {worst} "
          f"gradient norm {nk[worst]} with the kernels, {nt[worst]} twins")
    out = {"config": f"{ARCH} depth {LAYERS}", "batch": TRAIN_B,
           "seq": TRAIN_S, "steps": TRAIN_STEPS, "loss": losses,
           "ms_per_step": ms, "ms_per_step_all": [1e3 * rec["step_s"][s]
                                                  for s in range(TRAIN_STEPS)],
           "tokens_per_s": TRAIN_B * TRAIN_S / (ms / 1e3),
           "peak_gib": peak,
           "launches_per_step": {n: launches[n] / TRAIN_STEPS
                                 for n in ("bgmv", "bgmv_expert", "gmm")},
           "profile": prof,
           "step0": {"loss_kernels": lk, "loss_twins": lt,
                     "grad_norms_kernels": nk, "grad_norms_twins": nt,
                     "worst_norm_rel_err": [worst, norm_err[worst]]}}
    print("phase 12(ii) fine-tune: " + json.dumps(out) + f"; card {smi}",
          flush=True)
    return out, rec, launches


def train_batch(torch, cfg, batch: int, seq: int, step: int) -> dict:
    """The launcher's batch of ``step`` (tenant 0) on the card."""
    from repro_torch.training import data as tdata
    toks, labels = tdata.batch_at(tdata.DataConfig(cfg.vocab_size, seq,
                                                   batch), step)
    return {"tokens": torch.as_tensor(toks, device="cuda"),
            "labels": torch.as_tensor(labels, device="cuda")}


def direct_engine(torch, cfg, params, pool, mode):
    """The engine given ``pool``'s adapters directly: disagg, a LoRA-Server
    pool with every adapter resident and the fused transport; coupled,
    the pool in the model."""
    from repro_torch.core.lora_server import pool_tensors_from_adapter
    from repro_torch.launch import serve
    from repro_torch.serving.cache import LoRACache
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.server_pool import ServerPool
    ecfg = dataclasses.replace(serve.ENGINE, paged=True)
    if mode == "coupled":
        return Engine(cfg, params, ecfg, pool=pool, device="cuda")
    sp = ServerPool.build(pool.cfg, pool, cache_slots=pool.n,
                          dtype=torch.bfloat16, device="cuda")
    every = LoRACache(pool.n, adapter_bytes=0, n_layers=cfg.n_layers,
                      layerwise=False, prefetch=False)
    for aid in range(pool.n):
        every.admit(aid, 0.0)
    sp.sync(every, lambda a: pool_tensors_from_adapter(pool, a),
            pool.rank_of)
    return Engine(cfg, params, ecfg, server=sp, pool=pool,
                  transport="fused", device="cuda")


def serve_trained(torch, smi, rec) -> dict:
    """Phase 12(iv): the adapter of (ii) through ``ServeSystem.
    load_adapter`` (true rank 8 in the rank-32 pool, alpha 16) on its base
    weights: its gate/up/down into the main path (disaggregated, paged,
    fused), all seven targets into the coupled plane (appended to the
    pool). On each, 4 requests on it give the tokens of the engine given
    the same tensors directly; the count of its tokens that differ from
    the untrained adapter's (loaded beside it)."""
    from repro_torch.launch import serve, train
    from repro_torch.serving.api import build_system
    from repro_torch.training.train_step import host_tensors

    cfg, params = rec["cfg"], rec["params"]
    untrained, _ = train.build_adapter(cfg, train.parser().parse_args(
        ["--device", "cuda"]))
    traffic = dataclasses.replace(serve.Traffic(adapter_ranks=RANKS),
                                  n_requests=4, new_tokens=SERVE_TOKENS)
    new = len(RANKS)
    reqs = [(rid, p, new) for rid, p, _ in serve.make_requests(cfg, traffic,
                                                               SEED)]
    base_reqs = [(rid, p, new + 1) for rid, p, _ in reqs]
    out = {}
    for mode in ("disagg", "coupled"):
        targets = FFN_TARGETS if mode == "disagg" else None
        trained, plain = host_tensors(rec["adapter"], targets), \
            host_tensors(untrained, targets)
        pool = serve.adapter_pool(cfg, mode, RANKS, seed=SEED,
                                  dtype=torch.bfloat16, device="cuda")
        kw = {"transport": "fused"} if mode == "disagg" else {}
        system = build_system(serve.serve_config(
            traffic, mode, adapter_cache_slots=new + 2, **kw), pool.cfg,
            params=params, pool=pool)
        try:
            check(system.load_adapter(new, trained, alpha=TRAIN_ALPHA)
                  == TRAIN_RANK, f"serve {mode}: load_adapter's rank")
            check(system.load_adapter(new + 1, plain, alpha=TRAIN_ALPHA)
                  == TRAIN_RANK, f"serve {mode}: load_adapter's rank")
            res = serve.serve_system(system, reqs, traffic)
            base = serve.serve_system(system, base_reqs, traffic)
        finally:
            system.close()
        direct = dataclasses.replace(pool, tensors={
            t: dict(ab) for t, ab in pool.tensors.items()})
        f = (TRAIN_ALPHA / TRAIN_RANK) / pool.scale
        direct.append({k: v * f if k.endswith(".B") else v
                       for k, v in trained.items()}, TRAIN_RANK)
        want = serve.serve(direct_engine(torch, cfg, params, direct, mode),
                           reqs, traffic)["tokens"]
        plane_check(cfg, res, traffic, f"serve {mode}", want)
        n_diff = sum(a != b for r in res["tokens"]
                     for a, b in zip(res["tokens"][r], base["tokens"][r]))
        out[mode] = {"tokens_equal_engine": True,
                     "tokens": sum(len(v) for v in res["tokens"].values()),
                     "differ_from_untrained": n_diff,
                     "wall_ms_per_round": res["wall_ms_per_round"]}
        del system, direct
        free_device(torch)
    print("phase 12(iv) the trained adapter served: " + json.dumps(out)
          + f"; card {smi}", flush=True)
    return out


def full_training(torch, smi) -> dict:
    """Phase 12(iii): ``python -m repro_torch.launch.train`` in its
    full-parameter mode (its ``run``) at smollm-360m's full width and depth,
    f32, B 8 x S 4096, FULL_STEPS steps with a checkpoint every FULL_CKPT;
    then a second run with fresh objects from that checkpoint alone: its losses
    and final weights held bit for bit to the uninterrupted run's (the
    largest differences printed); one more step profiled."""
    import shutil
    import tempfile

    from repro_torch.launch import train
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.tree import flatten_with_keys

    argv = ["--arch", FULL_ARCH, "--batch", str(FULL_B), "--seq",
            str(FULL_S), "--steps", str(FULL_STEPS), "--log-every", "5",
            "--ckpt-every", str(FULL_CKPT)]
    with tempfile.TemporaryDirectory() as tmp:
        run_dir, resume_dir = pathlib.Path(tmp, "run"), \
            pathlib.Path(tmp, "resume")
        torch.cuda.reset_peak_memory_stats()
        first = train.run(argv + ["--ckpt", str(run_dir)])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        step = f"step_{FULL_CKPT:08d}"
        shutil.copytree(run_dir / step, resume_dir / step)
        first_params = {k: v.detach().clone() for k, v in
                        flatten_with_keys(first["params"]).items()}
        first_losses, first_s = dict(first["losses"]), dict(first["step_s"])
        del first
        free_device(torch)
        second = train.run(argv + ["--ckpt", str(resume_dir)])
        torch.cuda.synchronize()
    step = make_train_step(second["cfg"], AdamWConfig(
        lr=1e-3, warmup_steps=10, total_steps=FULL_STEPS))
    last = train_batch(torch, second["cfg"], FULL_B, FULL_S, FULL_STEPS)
    prof = step_profile(torch, lambda: step(
        second["params"], second["opt_state"], last)[0].item())
    check(second["start"] == FULL_CKPT, f"resume: started at "
          f"{second['start']}")
    losses = [first_losses[s] for s in range(FULL_STEPS)]
    check(all(math.isfinite(v) for v in losses), f"full training: {losses}")
    resumed = {s: second["losses"][s] for s in range(FULL_CKPT, FULL_STEPS)}
    loss_diff = max(abs(resumed[s] - first_losses[s]) for s in resumed)
    w_diff = max((v - first_params[k]).abs().max().item() for k, v in
                 flatten_with_keys(second["params"]).items())
    bit_equal = loss_diff == 0 and all(
        torch.equal(v, first_params[k]) for k, v in
        flatten_with_keys(second["params"]).items())
    warm = [first_s[s] for s in range(TRAIN_WARM, FULL_STEPS)]
    ms = 1e3 * statistics.median(warm)
    out = {"config": f"{FULL_ARCH} full width and depth, f32",
           "batch": FULL_B, "seq": FULL_S, "steps": FULL_STEPS,
           "loss": losses, "ms_per_step": ms,
           "ms_per_step_all": [1e3 * first_s[s] for s in range(FULL_STEPS)],
           "tokens_per_s": FULL_B * FULL_S / (ms / 1e3), "peak_gib": peak,
           "resumed_at": FULL_CKPT,
           "resumed_loss": [resumed[s] for s in sorted(resumed)],
           "resume_bit_equal": bit_equal,
           "resume_max_loss_diff": loss_diff,
           "resume_max_weight_diff": w_diff, "profile": prof}
    print("phase 12(iii) full training: " + json.dumps(out) + f"; card {smi}",
          flush=True)
    check(bit_equal, f"resume: steps {FULL_CKPT}-{FULL_STEPS - 1} not bit "
          f"equal to the uninterrupted run (loss {loss_diff}, weights "
          f"{w_diff})")
    return out


def train_phase(torch, ops, ref, counters, flush, smi):
    """Phase 12: the training plane. Returns ({kernel: its autograd
    readings}, path (a)'s launch counts)."""
    from repro_torch.obs.clock import wall_time

    t0 = wall_time()
    grads = train_kernels(torch, ops, ref, flush)
    free_device(torch)
    fine, rec, launches = lora_finetune(torch, ops, ref, counters, smi)
    for name in grads:
        grads[name]["launches_per_step"] = fine["launches_per_step"][name]
    serve_trained(torch, smi, rec)
    del rec
    free_device(torch)
    full_training(torch, smi)
    free_device(torch)
    print(f"phase 12: {wall_time() - t0:.1f} s", flush=True)
    return grads, launches


# ------------------------------ phase 13 ----------------------------- #
# the collective-bearing SPMD steps on NCCL, one process a card: W = 2
# ranks where two cards are visible, else W = 1 (every grid is then the
# local plan, and no check crosses cards). (i) make_serve_step at the
# serving cell's width and depth, (ii) the data-parallel LoRA fine-tune,
# (iii) make_train_step at depth 1 and make_prefill_step at depth LAYERS
SPMD_B, SPMD_S, SPMD_PROMPT, SPMD_STEPS = 8, 2048, 1536, 16
SPMD_DP_STEPS = 5
SPMD_TRAIN_B, SPMD_TRAIN_S, SPMD_TRAIN_LR = 2, 1024, 1e-3
SPMD_TIMEOUT, SPMD_JOIN = 120, 480      # a collective, the whole world
# the DP fine-tune's first step against one card's mean of the ranks'
# shares' steps (bf16 base, the same kernels; the all-reduce sums in
# another order): the loss, each gradient's norm
DP_LOSS_TOL, DP_NORM_TOL = 1e-3, 1e-2
# make_train_step, dropless (a rank's capacity would count its own tokens
# and drop other pairs than the local step): the loss within SPMD_LOSS_TOL
# relative; each leaf's gradient, read from AdamW's first moment after the
# step (m = (1 - b1) g in f32, so both sides read it the same way), within
# GRAD_REL_TOL of the local step's: its norm, and the relative L2 error of
# a sample of it (``leaf_reading``). Two planted faults, computed on
# the local step, must each break that bound: half the batch left out, and
# half the tokens not summed (the gradient a rank holds before the sum
# over the token axes). One card (W = 1): equal, bit for bit
SPMD_LOSS_TOL, GRAD_REL_TOL = 1e-3, 5e-2
# the serve step against the local one on the same state: the median
# over (step, row) of a row's largest logit difference within LOGIT_TOL.
# Not the median step's largest: a router's top-8 near-tie decided the
# other way moves its row's logits by ~0.05, and over two cards, as for
# the local step run as two half batches (other GEMM shapes, the same
# math), such a row turned up in more than half of the 16 steps; the
# floor of those two halves is printed beside


def spmd_world(torch) -> int:
    return 2 if torch.cuda.device_count() >= 2 else 1


def spmd_grids(W: int):
    return [(1, W), (W, 1)] if W > 1 else [(1, 1)]


def _bits(torch, t):
    """A bf16 or f32 tensor as a numpy array that pickles by value (bf16
    by its bit pattern)."""
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _unbits(torch, a, dev):
    t = torch.from_numpy(a)
    return (t.view(torch.bfloat16) if t.dtype == torch.int16 else t).to(dev)


def _median_max_err(torch, got, want):
    """(median over steps of the largest |logit difference|, greedy
    agreement, the largest) of (n, B, V) logits."""
    errs = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got, want)]
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    return statistics.median(errs), agree, max(errs)


def _median_row_err(torch, got, want) -> float:
    """The median over every (step, row) of its largest |logit
    difference|: a router's near-tie decided the other way moves its
    row's logits far, and a few such rows set a step's largest."""
    return (got.float() - want.float()).abs().amax(-1).median().item()


def _spmd_serve_inputs(torch, cfg, dev):
    """The prompts, the adapter ids a row (the pool's four adapters) and
    the decode's lora pool: expert-FFN adapters of true ranks RANKS."""
    import numpy as np

    from repro_torch.launch import serve
    rng = np.random.default_rng(SEED + 13)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (
        SPMD_B, SPMD_PROMPT)), device=dev)
    ids = torch.arange(SPMD_B, dtype=torch.int32, device=dev) % len(RANKS)
    pool = serve.adapter_pool(cfg, "disagg", RANKS, seed=SEED,
                              dtype=torch.bfloat16, device=dev)
    return prompts, ids, pool


def spmd_baseline(torch, smi) -> dict:
    """The single-card local steps of phase 13 on cuda:0, their outputs
    on the host: (i) the prompt's KV (a prefill of SPMD_PROMPT tokens) and
    SPMD_STEPS greedy decode steps with the expert adapters, each step's
    logits and tokens; (ii) the LoRA fine-tune's first step on the whole
    batch (loss, gradient norms); (iii) make_train_step's local twin at
    depth 1, dropless (loss, each leaf's first moment after the step, and
    the two planted faults' gradient errors) and the prefill's logits at
    depth LAYERS (every 8th position)."""
    from repro_torch.distributed import steps as tsteps
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer
    from repro_torch.models.cache import init_cache
    from repro_torch.training import optimizer as topt
    from repro_torch.training.train_step import lm_loss, make_lora_loss, \
        value_and_grad

    dev = torch.device("cuda", 0)
    out = {}
    cfg, params = serve.model(ARCH, layers=LAYERS, seed=SEED, device=dev)
    prompts, ids, pool = _spmd_serve_inputs(torch, cfg, dev)
    with torch.no_grad():
        _, (k, v) = transformer.forward(params, cfg, prompts,
                                        collect_kv=True, unembed=False)
        out["kv"] = (_bits(torch, k), _bits(torch, v))
        cache = init_cache(cfg, SPMD_B, SPMD_S, device=dev)
        cache["k"][:, :, :SPMD_PROMPT] = k
        cache["v"][:, :, :SPMD_PROMPT] = v
        cache["pos"] = SPMD_PROMPT
        del k, v
        tok = prompts[:, -1:]
        toks, logits, ms = [], [], []
        ctx = pool.lora_ctx(ids)
        mem = memory_cell(torch, cfg, params, cache)
        for _ in range(SPMD_STEPS):
            t0 = time_now(torch)
            lg, cache = transformer.decode_step(params, cfg, cache, tok,
                                                lora_ctx=ctx)
            ms.append(time_now(torch) - t0)
            tok = lg.argmax(-1, keepdim=True).to(prompts.dtype)
            toks.append(tok.cpu())
            logits.append(lg.float().cpu())
        memory_report(torch, smi, mem)
        out["serve"] = {"tokens": torch.stack(toks).numpy(),
                        "logits": torch.stack(logits).numpy(),
                        "ms_per_step": 1e3 * statistics.median(ms[2:])}
    del cache, ctx
    free_device(torch)
    # (ii) the fine-tune's first step on the whole batch, and the
    # data-parallel algorithm on one card: the mean of the W shares' steps
    args = train.parser().parse_args(["--device", "cuda"])
    adapter, scale = train.build_adapter(cfg, args)
    batch = train_batch(torch, cfg, TRAIN_B, TRAIN_S, 0)
    loss_fn = make_lora_loss(cfg, params, scale)
    loss, grads = value_and_grad(loss_fn, adapter, batch)
    out["dp"] = {"loss": loss.item(), "norms": grad_norms(torch, grads)}
    W, per = spmd_world(torch), TRAIN_B // spmd_world(torch)
    losses, mean = [], None
    for r in range(W):
        lr_, gr = value_and_grad(loss_fn, adapter, {
            k: v[r * per:(r + 1) * per] for k, v in batch.items()})
        losses.append(lr_.item())
        mean = gr if mean is None else {
            t: {f: mean[t][f] + gr[t][f] for f in gr[t]} for t in gr}
    mean = {t: {f: x / W for f, x in ab.items()} for t, ab in mean.items()}
    out["dp_shares"] = {"loss": sum(losses) / W,
                        "norms": grad_norms(torch, mean)}
    del grads, adapter, mean, gr, loss_fn     # the loss holds the weights
    free_device(torch)
    # the prefill's logits at depth LAYERS, as configured and dropless
    toks = train_batch(torch, cfg, SPMD_TRAIN_B, SPMD_TRAIN_S, 1)["tokens"]
    for key, c in (("prefill", cfg), ("prefill_dropless", dropless(cfg))):
        with torch.no_grad():
            lg = transformer.forward(params, c, toks, kind="prefill")[0]
        out[key] = lg[:, ::8].float().cpu().numpy()
        del lg
    del params, pool
    free_device(torch)
    # (iii) the full-parameter step at depth 1, dropless (make_train_step's
    # local twin: the same loss, gradients and in-place AdamW, no rules)
    cfg1, p1 = serve.model(ARCH, layers=1, seed=SEED, device=dev)
    cfg1 = dropless(cfg1)
    batch = train_batch(torch, cfg1, SPMD_TRAIN_B, SPMD_TRAIN_S, 2)

    def loss_of(p, b):
        return lm_loss(transformer.forward(p, cfg1, b["tokens"],
                                           kind="train")[0], b["labels"])

    # the planted faults' gradients: half the batch (row 0 alone), and
    # half the tokens unsummed (the first half of each sequence: their
    # nll sum over every label, = half the mean over their own labels)
    faults = {}
    _, g = value_and_grad(loss_of, p1, {k: v[:1] for k, v in batch.items()})
    faults["half_batch"] = grad_readings(torch, g)
    del g
    half = batch["labels"].clone()
    half[:, SPMD_TRAIN_S // 2:] = -1
    _, g = value_and_grad(loss_of, p1, dict(batch, labels=half))
    faults["half_tokens_unsummed"] = grad_readings(torch, g, scale=0.5)
    del g, half
    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    loss, grads = value_and_grad(loss_of, p1, batch)
    true = grad_readings(torch, grads)
    opt = topt.init(p1)
    tsteps.adamw_(p1, grads, opt, topt.AdamWConfig(
        lr=SPMD_TRAIN_LR, warmup_steps=1, total_steps=10))
    del grads
    out["train"] = {"loss": loss.item(), "m": grad_readings(torch, opt["m"]),
                    "planted": {k: readings_err(f, true)
                                for k, f in faults.items()},
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del p1, opt
    free_device(torch)
    return out


def dropless(cfg):
    """``cfg`` with a capacity factor of E / K: a capacity of at least T
    slots an expert, so no (token, expert) pair overflows whatever the
    number of tokens (a rank's or the whole batch's)."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def time_now(torch) -> float:
    from repro_torch.obs.clock import wall_time
    torch.cuda.synchronize()
    return wall_time()


def grad_readings(torch, tree, scale=1.0) -> dict:
    """{leaf: (a sample (f32 numpy), the f32 norm of the whole leaf)},
    each times ``scale`` (a power of two: exact)."""
    from repro_torch.training.tree import flatten_with_keys
    return {k: leaf_reading(v, scale)
            for k, v in flatten_with_keys(tree).items()}


def leaf_reading(v, scale=1.0):
    """A leaf's sample, every 4099th element where it has more than 4099
    x 4096 of them, else the whole leaf (a norm's 4096 weights would
    give one element, whose sum over the tokens may cancel), and its
    norm."""
    v = v.float() * scale
    step = 4099 if v.numel() > 4099 * 4096 else 1
    return v.reshape(-1)[::step].cpu().numpy(), v.norm().item()


def readings_err(got, want) -> dict:
    """The worst leaf's relative errors of ``got`` against ``want``
    (``grad_readings``): the sample's L2 error over its L2 norm, and the
    norms' (a leaf whose want is zero counts as wrong unless got is)."""
    import numpy as np

    def rel(e, n):
        return e / n if n > 0 else (0.0 if e == 0 else math.inf)

    samp = {k: rel(float(np.linalg.norm(got[k][0] - w[0])),
                   float(np.linalg.norm(w[0]))) for k, w in want.items()}
    norm = {k: rel(abs(got[k][1] - w[1]), w[1]) for k, w in want.items()}
    ks, kn = max(samp, key=samp.get), max(norm, key=norm.get)
    return {"sample_rel_l2": samp[ks], "sample_leaf": ks,
            "norm_rel": norm[kn], "norm_leaf": kn,
            "equal": all(np.array_equal(got[k][0], w[0]) and got[k][1] == w[1]
                         for k, w in want.items())}


def spmd_rank(rank, world, base):
    """One rank of phase 13 (on card ``rank``): (i), (ii), (iii) in turn;
    rank 0 returns the readings, every rank its peak memory."""
    import torch
    from repro_torch.kernels import bgmv, fused, gmm, paged, sgmv
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = {"paged_attention": paged.paged_attention,
                "bgmv_expert": bgmv.bgmv_expert, "bgmv": bgmv.bgmv,
                "bgmv_ranked": bgmv.bgmv_ranked, "sgmv": sgmv.sgmv,
                "sgmv_ranked": sgmv.sgmv_ranked,
                "fused_sgmv": fused.fused_sgmv,
                "fused_sgmv_ranked": fused.fused_sgmv_ranked, "gmm": gmm.gmm}
    from repro_torch.launch import serve
    main = Launches(counters)
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg, params = serve.model(ARCH, layers=LAYERS, seed=SEED, device=dev)
    out = {"rank": rank,
           "serve": spmd_serve_rank(torch, world, base, cfg, params, main),
           "dp": spmd_dp_rank(torch, world, base, cfg, params, main),
           "prefill": spmd_prefill_rank(torch, world, base, cfg, params,
                                        main)}
    del params
    free_device(torch)
    out["train"] = spmd_train_rank(torch, world, base, main)
    out["launches"] = main.n
    return out


class Launches:
    """The launches of the sharded steps alone: ``with main.count():``
    adds what each kernel launched inside it. The local steps run beside
    them to compare, and the checks' own passes, are not counted."""

    def __init__(self, counters):
        self.counters = counters
        self.n = dict.fromkeys(counters, 0)

    @contextlib.contextmanager
    def count(self):
        c0 = {k: f.launches for k, f in self.counters.items()}
        yield
        for k, f in self.counters.items():
            self.n[k] += f.launches - c0[k]


def spmd_serve_rank(torch, W, base, cfg, params, main) -> dict:
    """(i) ``jit_serve_step`` on each grid: the prompt's KV cut to this
    rank's batch rows and kv_seq slice, SPMD_STEPS steps fed the local
    run's tokens (lock step), every step's logits gathered. Before each
    step the cache is gathered whole and rank 0 runs the local step on
    that same state: each step's logits are held to it (as phase 3 holds
    the kernels to the plain versions). The drift from the one-card run,
    whose cache holds its own roundings (a router's near-tie decided the
    other way stays in the KV it wrote), is printed beside."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import steps as tsteps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats()
    mem = StepMemory(torch)
    prompts, ids, pool = _spmd_serve_inputs(torch, cfg, dev)
    k_all, v_all = (_unbits(torch, a, dev) for a in base["kv"])
    shape = ShapeConfig("spmd_serve", seq_len=SPMD_S, global_batch=SPMD_B,
                        kind="decode")
    want = base["serve"]
    out = {}
    for grid in spmd_grids(W):
        mesh = make_debug_mesh(*grid)
        step, _, rules = tsteps.jit_serve_step(cfg, shape, mesh)
        _, cpl = tsteps.cache_specs(cfg, shape, rules)
        place = tsteps.step_placements(cfg, rules)
        p_l = _clone_sharded(torch, tsteps.local_params(params, place),
                             place)
        loc = {}
        for name, src in (("k", k_all), ("v", v_all)):
            pl = cpl[name]
            buf = torch.zeros(pl.local_shape, dtype=torch.bfloat16,
                              device=dev)
            # this rank's rows and slice of the prompt's positions
            b0 = mesh.coord(pl.spec[1]) * buf.shape[1] if pl.spec[1] else 0
            s0 = mesh.coord(pl.spec[2]) * buf.shape[2] if pl.spec[2] else 0
            n = max(0, min(SPMD_PROMPT - s0, buf.shape[2]))
            if n:
                buf[:, :, :n] = src[:, b0:b0 + buf.shape[1], s0:s0 + n]
            loc[name] = buf
        loc["pos"] = SPMD_PROMPT
        layout = layout_bytes(cfg, shape, rules, "decode", p_l, cache=loc)
        bspec = rules.spec(("batch", None), (SPMD_B, 1))
        bpl = tsteps.Placement(mesh, bspec, (SPMD_B, 1))
        ctx = pool.lora_ctx(bpl.local(ids[:, None])[:, 0].contiguous())
        toks = torch.as_tensor(want["tokens"], device=dev)
        want_logits = torch.from_numpy(want["logits"])
        feed = [prompts[:, -1:]] + [toks[i] for i in range(SPMD_STEPS - 1)]
        c0 = dict(main.n)
        mem.above = 0
        got, shadow, halves, ms = [], [], [], []
        h = SPMD_B // 2
        for t in feed:
            # the same state through the local step, on rank 0: the whole
            # batch, and its two halves as two batches (the noise floor of
            # the same math over other GEMM shapes and sum orders; each
            # half rewrites its rows' slot before it reads it)
            whole = {n: cpl[n].whole(loc[n]) for n in ("k", "v")}
            if mesh.rank == 0:
                with torch.no_grad():
                    lg, _ = transformer.decode_step(
                        params, cfg, dict(whole, pos=loc["pos"]), t,
                        lora_ctx=pool.lora_ctx(ids))
                    shadow.append(lg.float().cpu())
                    halves.append(torch.cat([transformer.decode_step(
                        params, cfg, {"k": whole["k"][:, a:a + h],
                                      "v": whole["v"][:, a:a + h],
                                      "pos": loc["pos"]}, t[a:a + h],
                        lora_ctx=pool.lora_ctx(ids[a:a + h]))[0].float()
                        .cpu() for a in (0, h)]))
            del whole
            t0 = time_now(torch)
            with main.count(), mem.step():
                lg, loc = step(p_l, loc, {"tokens": bpl.local(t)
                                          .contiguous()}, lora_ctx=ctx)
            ms.append(time_now(torch) - t0)
            g = lg if not bspec[0] else col.all_gather(
                lg.contiguous(), mesh.get_group(bspec[0]), 0)
            got.append(g.float().cpu())
        res = {"ms_per_step": 1e3 * statistics.median(ms[2:]),
               "local_ms_per_step": want["ms_per_step"],
               "launches_per_step": {k: (main.n[k] - c0[k]) / SPMD_STEPS
                                     for k in ("gmm", "bgmv_expert",
                                               "bgmv")},
               "plan": _plan_of(cfg, rules, "decode", SPMD_B, 1),
               "layout_bytes": layout}
        step_memory(layout, mem.above)
        if mesh.rank == 0:
            med, agree, worst = _median_max_err(torch, torch.stack(got),
                                                torch.stack(shadow))
            res.update(median_row_max_logit_err=_median_row_err(
                torch, torch.stack(got), torch.stack(shadow)),
                median_max_logit_err=med, max_logit_err=worst,
                greedy_agree=agree)
            med, agree, worst = _median_max_err(torch, torch.stack(halves),
                                                torch.stack(shadow))
            res["floor_two_halves"] = {"median_max_logit_err": med,
                                       "max_logit_err": worst,
                                       "greedy_agree": agree}
            med, agree, worst = _median_max_err(torch, torch.stack(got),
                                                want_logits)
            res["vs_one_card_run"] = {"median_max_logit_err": med,
                                      "max_logit_err": worst,
                                      "greedy_agree": agree}
        out[str(grid)] = res
        del p_l, loc
        free_device(torch)
    del pool, k_all, v_all
    free_device(torch)
    out["peak_gib"] = mem.rank_peak() / 2**30
    return out


def _plan_of(cfg, rules, kind, B, S) -> dict:
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models.moe import resolve_moe_plan
    with use_rules(rules):
        p = resolve_moe_plan(cfg, B, S, kind)
    return dataclasses.asdict(p)


def spmd_dp_rank(torch, W, base, cfg, params, main) -> dict:
    """(ii) ``make_lora_train_step(axis_name="data")`` over a (W, 1) mesh,
    each rank TRAIN_B / W rows of the phase-12 batch: the first step's
    gradients (all-reduced) against one card's on the whole batch, the
    all-reduce timed; the compressed reduction against its formula on the
    host (int32 sum of every rank's codes times the largest scale); then
    SPMD_DP_STEPS steps of each branch and the first batch's loss after
    them."""
    import numpy as np

    from repro_torch.distributed import collectives as col
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.training import compression
    from repro_torch.training.optimizer import AdamWConfig, init
    from repro_torch.training.train_step import _all_reduce_grads, \
        make_lora_loss, make_lora_train_step, value_and_grad
    from repro_torch.training.tree import flatten_with_keys

    mesh = make_debug_mesh(W, 1)
    g, r = mesh.get_group("data"), mesh.coord("data")
    torch.cuda.reset_peak_memory_stats()
    args = train.parser().parse_args(["--device", "cuda"])
    adapter, scale = train.build_adapter(cfg, args)
    per = TRAIN_B // W

    def share(step):
        b = train_batch(torch, cfg, TRAIN_B, TRAIN_S, step)
        return {k: v[r * per:(r + 1) * per].contiguous()
                for k, v in b.items()}

    loss_fn = make_lora_loss(cfg, params, scale)
    loss, grads = value_and_grad(loss_fn, adapter, share(0))
    loss = col.all_reduce(loss, g).item() / W
    zeros = compression.init_error(adapter)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    mean, _ = _all_reduce_grads(grads, zeros, g, W, False)
    end.record()
    torch.cuda.synchronize()
    ar_ms = start.elapsed_time(end)
    norms = grad_norms(torch, mean)
    # the compressed reduction against its formula on the host
    reduced, _ = _all_reduce_grads(grads, zeros, g, W, True)
    q, _ = compression.compress_tree(grads, zeros)
    formula_ok = True
    for key, (codes, sc) in _pairs(q, "").items():
        all_codes = col.all_gather(codes.to(torch.int32)[None], g, 0)
        all_sc = col.all_gather(sc.reshape(1), g, 0)
        host = (all_codes.cpu().numpy().astype(np.int64).sum(0)
                .astype(np.float32) * np.float32(all_sc.max().item()))
        formula_ok &= bool(np.array_equal(
            host, flatten_with_keys(reduced)[key].cpu().numpy()))
    del grads, mean, reduced, q
    out = {"world": W, "rows_per_rank": per, "step0_loss": loss,
           "step0_loss_local": base["dp_shares"]["loss"],
           "allreduce_ms": ar_ms, "compressed_formula_bit_equal": formula_ok}

    def worst(nt):
        return max(abs(norms[k] - nt[k]) / max(nt[k], 1e-30) for k in nt)

    out["worst_norm_rel_err"] = worst(base["dp_shares"]["norms"])
    # one card's step on the whole batch: its capacity is the whole
    # batch's, so it drops other overflow pairs than the ranks do
    out["vs_whole_batch"] = {"step0_loss": base["dp"]["loss"],
                             "worst_norm_rel_err": worst(base["dp"]["norms"])}
    for compress in (False, True):
        name = "compressed" if compress else "pmean"
        ad = {t: {f: x.clone() for f, x in ab.items()}
              for t, ab in adapter.items()}
        step = make_lora_train_step(
            cfg, params, scale, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=SPMD_DP_STEPS),
            compress=compress, axis_name="data", mesh=mesh)
        opt, err = init(ad), compression.init_error(ad)
        losses, ms = [], []
        for s in range(SPMD_DP_STEPS):
            b = share(s)
            t0 = time_now(torch)
            with main.count():
                lo, ad, opt, err = step(ad, opt, err, b)
            losses.append(col.all_reduce(lo, g).item() / W)
            ms.append(time_now(torch) - t0)
        # the first batch again, after the steps
        with torch.no_grad():
            after = col.all_reduce(loss_fn(ad, share(0)), g).item() / W
        out[name] = {"loss": losses, "step0_batch_after": after,
                     "ms_per_step": 1e3 * statistics.median(ms[1:])}
        del ad, opt, err
        free_device(torch)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _pairs(t, prefix):
    """A tree of (codes, scale) pairs as {key path: pair}, its keys as
    ``flatten_with_keys`` writes them."""
    if isinstance(t, tuple):
        return {prefix: t}
    out = {}
    for k in sorted(t):
        out.update(_pairs(t[k], prefix + f"[{k!r}]"))
    return out


def spmd_train_rank(torch, W, base, main) -> dict:
    """(iii) ``jit_train_step`` at depth 1, dropless, over a (1, W) mesh
    (sequence parallelism, head-sharded flash attention, the experts'
    all-to-all), B SPMD_TRAIN_B x S SPMD_TRAIN_S, one AdamW step, against
    the local step: its loss, and each leaf's first moment after the step
    (the gradient the step applied, summed over the ranks), gathered whole
    one leaf at a time."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import steps as tsteps
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.training import optimizer as topt
    from repro_torch.training.tree import flatten_with_keys

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_debug_mesh(1, W)
    out = {"grid": str((1, W))}
    cfg1, p1 = serve.model(ARCH, layers=1, seed=SEED, device=dev)
    cfg1 = dropless(cfg1)
    shape = ShapeConfig("spmd_train", seq_len=SPMD_TRAIN_S,
                        global_batch=SPMD_TRAIN_B, kind="train")
    step, _, rules = tsteps.jit_train_step(
        cfg1, shape, mesh, topt.AdamWConfig(lr=SPMD_TRAIN_LR,
                                            warmup_steps=1, total_steps=10))
    place = tsteps.step_placements(cfg1, rules)
    p_l = {k: v for k, v in tsteps.local_params(p1, place).items()}
    p_l = _clone_sharded(torch, p_l, place)
    del p1
    free_device(torch)
    batch = train_batch(torch, cfg1, SPMD_TRAIN_B, SPMD_TRAIN_S, 2)
    bspec = rules.spec(("batch", "seq"), (SPMD_TRAIN_B, SPMD_TRAIN_S))
    bpl = tsteps.Placement(mesh, bspec, (SPMD_TRAIN_B, SPMD_TRAIN_S))
    b_l = {k: bpl.local(v).contiguous() for k, v in batch.items()}
    opt = topt.init(p_l)
    out["layout_bytes"] = layout_bytes(cfg1, shape, rules, "train", p_l,
                                       opt=opt)
    mem = StepMemory(torch)
    t0 = time_now(torch)
    with main.count(), mem.step():
        loss, p_l, opt = step(p_l, opt, b_l)
    out["ms_step"] = 1e3 * (time_now(torch) - t0)
    out["peak_gib_step"] = torch.cuda.max_memory_allocated() / 2**30
    step_memory(out["layout_bytes"], mem.above)
    del p_l
    free_device(torch)
    flat_pl = flatten_with_keys(place)
    got = {}
    for k, m in flatten_with_keys(opt["m"]).items():
        got[k] = leaf_reading(flat_pl[k].whole(m))
    del opt
    free_device(torch)
    want = base["train"]
    out["loss"], out["loss_local"] = loss.item(), want["loss"]
    out["grads"] = readings_err(got, want["m"])
    out["planted"] = want["planted"]
    return out


def spmd_prefill_rank(torch, W, base, cfg, params, main) -> dict:
    """(iii) ``jit_prefill_step`` at depth LAYERS on the (1, W) grid: the
    logits of every 8th position against the local prefill's, dropless
    (held: the same math) and as configured (printed: a rank's capacity
    counts its own tokens, so other overflow pairs drop)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import steps as tsteps
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(1, W)
    pshape = ShapeConfig("spmd_prefill", seq_len=SPMD_TRAIN_S,
                         global_batch=SPMD_TRAIN_B, kind="prefill")
    toks = train_batch(torch, cfg, SPMD_TRAIN_B, SPMD_TRAIN_S, 1)["tokens"]
    out = {"grid": str((1, W))}
    for key, c in (("prefill_dropless", dropless(cfg)), ("prefill", cfg)):
        pstep, _, prules = tsteps.jit_prefill_step(c, pshape, mesh)
        pplace = tsteps.step_placements(c, prules)
        bspec = prules.spec(("batch", "seq"), (SPMD_TRAIN_B, SPMD_TRAIN_S))
        bpl = tsteps.Placement(mesh, bspec, (SPMD_TRAIN_B, SPMD_TRAIN_S))
        p_l = _clone_sharded(torch, tsteps.local_params(params, pplace),
                             pplace)
        layout = layout_bytes(c, pshape, prules, "prefill", p_l)
        mem = StepMemory(torch)
        t0 = time_now(torch)
        with main.count(), mem.step():
            lg = pstep(p_l, {"tokens": bpl.local(toks).contiguous()})
        ms = 1e3 * (time_now(torch) - t0)
        step_memory(layout, mem.above)
        for dim, p in ((0, bspec[0]), (1, bspec[1])):
            if p:
                lg = col.all_gather(lg.contiguous(), mesh.get_group(p), dim)
        got = lg[:, ::8].float().cpu()
        del lg, p_l
        free_device(torch)
        med, agree, worst = _median_max_err(
            torch, got.transpose(0, 1),
            torch.from_numpy(base[key]).transpose(0, 1))
        out[key] = {"ms": ms, "median_max_logit_err": med,
                    "max_logit_err": worst, "greedy_agree": agree,
                    "layout_bytes": layout}
    return out


def _nbytes(tree) -> int:
    """The bytes of the tensors of a nested dict (host ints count 0)."""
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") \
        else 0


def layout_bytes(cfg, shape, rules, kind, params, opt=None,
                 cache=None) -> dict:
    """Phase 13, on every rank: the bytes of the parameter shards this
    rank's step holds (and of its AdamW moments, its cache's shards)
    beside ``analysis.memory_est``'s ``params`` (``opt_state``, ``cache``)
    for its grid, which must be equal; and memory_est's ``total_as_run``,
    which ``step_memory`` sets beside what the step took."""
    from repro_torch.analysis.memory_est import analytic_device_bytes
    an = analytic_device_bytes(cfg, shape, rules, kind)
    got = {"params": _nbytes(params)}
    if opt is not None:
        got["opt_state"] = _nbytes({"m": opt["m"], "v": opt["v"]})
    if cache is not None:
        got["cache"] = _nbytes(cache)
    return {"kind": kind, "allocated": got,
            "memory_est": {k: an[k] for k in got},
            "total_as_run": an["total_as_run"],
            "equal": all(got[k] == an[k] for k in got)}


class StepMemory:
    """The most bytes a step allocated above what was live before it (the
    allocator's peak reset at each step), and the running peak of the
    rank across those resets (``rank_peak``)."""

    def __init__(self, torch):
        self.torch, self.above, self.peak = torch, 0, 0

    @contextlib.contextmanager
    def step(self):
        cuda = self.torch.cuda
        self.peak = max(self.peak, cuda.max_memory_allocated())
        a0 = cuda.memory_allocated()
        cuda.reset_peak_memory_stats()
        yield
        self.above = max(self.above, cuda.max_memory_allocated() - a0)

    def rank_peak(self) -> int:
        return max(self.peak, self.torch.cuda.max_memory_allocated())


def step_memory(layout: dict, above: int) -> None:
    """Into ``layout``: the step's bytes as run, its held shards (the
    bytes memory_est counts at rest) plus the most it allocated above
    what was live, and their ratio to memory_est's ``total_as_run``."""
    run = sum(layout["allocated"].values()) + above
    layout.update(step_bytes_measured=run,
                  measured_over_total_as_run=run / layout["total_as_run"])


def _clone_sharded(torch, p_l, place):
    """The leaves this rank holds a part of as their own contiguous
    tensors (the kernels take no strides, and a view would keep the whole
    weight alive); the whole ones as they are."""
    if isinstance(p_l, dict):
        return {k: _clone_sharded(torch, v, place[k]) for k, v in p_l.items()}
    return p_l.clone() if place.local_shape != place.shape else p_l


def spmd_phase(torch, smi) -> dict:
    """Phase 13: the local baselines on cuda:0, then one NCCL world of W
    ranks (one a card) runs (i)-(iii); every check on rank 0's readings.
    Returns rank 0's launch counts (the kernels line's "spmd")."""
    from repro_torch.distributed.world import spawn
    from repro_torch.obs.clock import wall_time

    t0 = wall_time()
    W = spmd_world(torch)
    head = {"world": W, "grids": [str(g) for g in spmd_grids(W)],
            "cards": torch.cuda.device_count(), "backend": "nccl"}
    print(f"phase 13: the SPMD steps in the reference's parameter layout, "
          f"world {W} (NCCL, one rank a card; grids {head['grids']})"
          + ("; one card: every grid is the local plan and every placement "
             "whole, no check crosses cards; the layout's cross-rank proof "
             "is the CPU's 4-rank gloo world (tests/test_torch_spmd_layout"
             ".py) and phase 14(c)'s meta dry run of the (16, 16) mesh"
             if W == 1 else ""), flush=True)
    base = spmd_baseline(torch, smi)
    free_device(torch)      # the ranks share cuda:0 with this process
    t1 = wall_time()
    ranks = spawn(spmd_rank, W, base, backend="nccl", timeout=SPMD_TIMEOUT,
                  join_timeout=SPMD_JOIN)
    r0 = ranks[0]
    peaks = {part: [r[part].pop("peak_gib") for r in ranks]
             for part in ("serve", "dp")}
    peaks["train"] = [r["train"]["peak_gib_step"] for r in ranks]
    dp, tr, pf = r0["dp"], r0["train"], r0["prefill"]
    layout = [{"rank": r["rank"],
               **{f"serve {g}": res.pop("layout_bytes")
                  for g, res in r["serve"].items()},
               "train": r["train"].pop("layout_bytes"),
               **{k: v.pop("layout_bytes") for k, v in r["prefill"].items()
                  if isinstance(v, dict)}} for r in ranks]
    # every line first, then the checks: a failure shows all readings
    print("phase 13 parameter, moment and cache bytes a rank against "
          "memory_est, and each step's bytes as run (its shards + the most "
          "it allocated above them) against memory_est's total_as_run: "
          + json.dumps(layout) + f"; card {smi}", flush=True)
    for grid, res in r0["serve"].items():
        print(f"phase 13(i) serve {grid}: " + json.dumps(
            {**head, **res, "peak_gib_by_rank": peaks["serve"]})
            + f"; card {smi}", flush=True)
    print("phase 13(ii) data-parallel fine-tune: " + json.dumps(
        {**head, **dp, "peak_gib_by_rank": peaks["dp"]}) + f"; card {smi}",
        flush=True)
    print("phase 13(iii) train + prefill: " + json.dumps(
        {**head, **tr, "prefill": pf, "peak_gib_by_rank": peaks["train"],
         "local_peak_gib": base["train"]["peak_gib"]})
        + f"; card {smi}", flush=True)
    for r in layout:
        for part, lb in r.items():
            check(part == "rank" or lb["equal"],
                  f"spmd rank {r['rank']} {part}: the bytes held are not "
                  f"memory_est's: {lb}")
    for grid, res in r0["serve"].items():
        check(res["median_row_max_logit_err"] <= LOGIT_TOL,
              f"spmd serve {grid}: median (step, row) logit err "
              f"{res['median_row_max_logit_err']} > {LOGIT_TOL}")
        check(res["greedy_agree"] >= ARGMAX_AGREE,
              f"spmd serve {grid}: greedy agreement {res['greedy_agree']}")
        check(res["launches_per_step"]["gmm"] > 0,
              f"spmd serve {grid}: gmm never launched")
    check(abs(dp["step0_loss"] - dp["step0_loss_local"])
          <= DP_LOSS_TOL * abs(dp["step0_loss_local"]),
          f"spmd fine-tune: step-0 loss {dp['step0_loss']} against "
          f"{dp['step0_loss_local']} on one card")
    check(dp["worst_norm_rel_err"] <= DP_NORM_TOL,
          f"spmd fine-tune: a gradient norm off by {dp['worst_norm_rel_err']}")
    check(dp["compressed_formula_bit_equal"],
          "spmd fine-tune: the compressed all-reduce is not the formula's")
    for name in ("pmean", "compressed"):
        ls = dp[name]["loss"]
        check(all(math.isfinite(v) for v in ls)
              and dp[name]["step0_batch_after"] < ls[0],
              f"spmd fine-tune {name}: the first batch's loss did not fall "
              f"({ls[0]} -> {dp[name]['step0_batch_after']})")
    g = tr["grads"]
    check(abs(tr["loss"] - tr["loss_local"])
          <= SPMD_LOSS_TOL * abs(tr["loss_local"]),
          f"spmd train: loss {tr['loss']} against {tr['loss_local']}")
    check(g["sample_rel_l2"] <= GRAD_REL_TOL and g["norm_rel"] <= GRAD_REL_TOL,
          f"spmd train: gradients off the local step's: {g}")
    check(W > 1 or (tr["loss"] == tr["loss_local"] and g["equal"]),
          f"spmd train, one card: not equal to the local step ({g})")
    for name, f in tr["planted"].items():
        check(max(f["sample_rel_l2"], f["norm_rel"]) > GRAD_REL_TOL,
              f"spmd train: planted fault {name} within the bound: {f}")
    check(pf["prefill_dropless"]["median_max_logit_err"] <= LOGIT_TOL
          and pf["prefill_dropless"]["greedy_agree"] >= ARGMAX_AGREE,
          f"spmd prefill: {pf['prefill_dropless']} against the local "
          f"prefill (dropless)")
    print(f"phase 13: {wall_time() - t0:.1f} s (local baselines "
          f"{t1 - t0:.1f} s)", flush=True)
    return r0["launches"]


# ------------------------------ phase 14 ------------------------------ #
# the analysis plane; each part runs where its state lives: (a) in the
# transport phase, (b) in phase 13's local baseline, (c)-(e) at the end
PHASE14 = {"seconds": {}}
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_TIMEOUT = 300


def _to_meta(tree):
    """Each tensor of a nested dict as a meta tensor (shapes, no data)."""
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return tree.to("meta") if hasattr(tree, "to") else tree


def _brief(counted) -> dict:
    return {k: counted[k] for k in ("flops", "hbm_bytes", "coll_total",
                                    "form", "kernels", "aten_ops")}


def roofline_cell(torch, smi, cfg, params, eng, fused_ms, replay) -> dict:
    """Phase 14(a): the fused plane's decode step of the 6 running rows
    (the transport phase's engine, R = 1, paged) counted twice by
    ``analysis.counter``: on the card, eagerly (the captured step's own
    function and inputs, the kernels launching, their work read from the
    data), and on the meta device at the same shapes (the twins' shape
    arithmetic, the kernels' shape form); the card's shape-form count must
    equal the meta one's. Then the roofline of the card's count against
    the fused ms/step the transport phase measured: the step's roofline
    share (bound / measured) and its mfu (model flops / (989 TFLOP/s x
    measured s))."""
    import numpy as np
    from repro_torch.analysis import roofline
    from repro_torch.analysis.counter import count
    from repro_torch.configs import ShapeConfig
    from repro_torch.obs.clock import wall_time
    from repro_torch.transport.base import decode_tokens
    from repro_torch.transport.fused import DeviceLoraView

    t0 = wall_time()
    tr, seen = eng.transport, []
    orig = tr.decode_step

    def record(p, c, k, v, toks, pos_vec, adapter_ids, lora_scale, **kw):
        seen.append((k, v, np.asarray(toks).reshape(-1), np.asarray(pos_vec),
                     np.asarray(adapter_ids), float(lora_scale),
                     kw.get("block_table")))
        return orig(p, c, k, v, toks, pos_vec, adapter_ids, lora_scale, **kw)

    tr.decode_step = record     # one engine step's inputs, as it gives them
    try:
        eng.step()
    finally:
        del tr.decode_step
    k, v, toks, pos, ids, scale, bt = seen[0]
    B = len(pos)

    def step_args(dev, prm, view, kk, vv):
        def i32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                   device=dev)
        return dict(params=prm, cfg=cfg, k=kk, v=vv, toks=i32(toks).view(
            B, 1), pos_vec=i32(pos), server=view, adapter_ids=i32(ids),
            lora_scale=torch.tensor(scale, dtype=torch.float32, device=dev),
            block_table=i32(bt))

    # the eager step rewrites the KV cells the engine's step wrote, with
    # the same values
    card = step_args(k.device, params, tr.view, k, v)
    with torch.no_grad(), count() as on_card:
        decode_tokens(**card)
    torch.cuda.synchronize()
    view = tr.view
    meta = step_args("meta", _to_meta(params), DeviceLoraView(
        _to_meta(view.pools), view.slot_lut.to("meta"),
        view.slot_ranks.to("meta"), view.r_pool), k.to("meta"),
        v.to("meta"))
    with torch.no_grad():
        decode_tokens(**meta)    # the meta device's RoPE table, once
        with count() as on_meta:
            decode_tokens(**meta)
    data, card_shape = on_card.summary("data"), on_card.summary("shape")
    meta_shape = on_meta.summary("shape")
    cell = ShapeConfig("smoke_decode", seq_len=int(pos.max()) + 1,
                       global_batch=B, kind="decode")
    rl = roofline.analyze(ARCH, cell.name, "one card", 1, data, 0, cfg,
                          cell)
    bound = 1e3 * rl.step_time
    out = {"rows": B, "layers": cfg.n_layers, "positions": pos.tolist(),
           "card": _brief(data), "card_shape_form": _brief(card_shape),
           "meta_shape_form": _brief(meta_shape),
           "card_eq_meta": {k: card_shape[k] == meta_shape[k] for k in (
               "flops", "hbm_bytes", "kernels")},
           "t_compute_ms": 1e3 * rl.t_compute,
           "t_memory_ms": 1e3 * rl.t_memory, "bottleneck": rl.bottleneck,
           "bound_ms": bound, "fused_ms_per_step": fused_ms,
           "roofline_share": bound / fused_ms,
           "mfu": rl.model_flops / (roofline.PEAK_FLOPS * fused_ms / 1e3),
           "model_flops": rl.model_flops,
           "replay_device_ms": replay["replay_device_ms"],
           "replay_bucket": replay["bucket"],
           # the same batch's replay (the transport phase's ms/step
           # averages steps of 2 to 8 active rows)
           "roofline_share_of_replay": bound / replay["replay_device_ms"],
           "top_ops": data["top_ops"]}
    PHASE14["seconds"]["a"] = wall_time() - t0
    print("phase 14(a) the fused decode step against its roofline: "
          + json.dumps(out) + f"; card {smi}", flush=True)
    check(all(out["card_eq_meta"].values()),
          f"phase 14(a): the card's shape-form count is not the meta "
          f"device's: {out['card_shape_form']} against "
          f"{out['meta_shape_form']}")
    check(data["kernels"].get("gmm", {}).get("calls") == 3 * cfg.n_layers
          and data["kernels"].get("bgmv_expert", {}).get("calls")
          == 2 * cfg.n_layers and math.isfinite(bound) and bound > 0,
          f"phase 14(a): the counted step is not the fused step: "
          f"{data['kernels']}")
    PHASE14["a"] = out
    return out


def memory_cell(torch, cfg, params, cache) -> dict:
    """Phase 14(b), before phase 13's local decode loop: the analytic
    bytes of its step (one card, the local plan) against the bytes of the
    allocated parameter and cache tensors, which must be equal; the peak
    counter is reset here, at rest."""
    from repro_torch.analysis.memory_est import analytic_device_bytes
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.steps import rules_for
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.obs.clock import wall_time

    t0 = wall_time()
    rules = rules_for(make_serve_mesh(1, 1, devices=["cuda:0"]), "decode",
                      cfg)
    shape = ShapeConfig("phase13_serve", seq_len=SPMD_S,
                        global_batch=SPMD_B, kind="decode")
    an = analytic_device_bytes(cfg, shape, rules, "decode")

    def nbytes(t):
        if isinstance(t, dict):
            return sum(nbytes(x) for x in t.values())
        return t.numel() * t.element_size() if hasattr(t, "numel") else 0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PHASE14["seconds"]["b"] = wall_time() - t0
    return {"analytic": an, "allocated": {"params": nbytes(params),
                                          "cache": nbytes(cache)},
            "at_rest_allocated": torch.cuda.memory_allocated()}


def memory_report(torch, smi, mem) -> None:
    """Phase 14(b), after the decode loop: the workspace estimate beside
    the peak above the at-rest bytes (reported, not held)."""
    an, got = mem["analytic"], mem["allocated"]
    out = {"params_analytic": an["params"], "params_allocated": got["params"],
           "cache_analytic": an["cache"], "cache_allocated": got["cache"],
           "workspace_estimate": an["workspace"],
           "workspace_measured": torch.cuda.max_memory_allocated()
           - mem["at_rest_allocated"],
           "at_rest_allocated": mem["at_rest_allocated"],
           "fits_80g": an["fits_80g"], "batch": SPMD_B, "cache_len": SPMD_S,
           "layers": LAYERS}
    print("phase 14(b) memory of phase 13's local serve step: "
          + json.dumps(out) + f"; card {smi}", flush=True)
    check(an["params"] == got["params"] and an["cache"] == got["cache"],
          f"phase 14(b): analytic bytes {an} against the allocated {got}")
    PHASE14["b"] = out


def host_jobs_start(out_dir: pathlib.Path):
    """The host-only work of phase 14, in a subprocess of its own with no
    card visible, started before phase 12 so that it runs on the host's
    cores while the card trains: (c) the dry run of ARCH's three shapes on
    the single production mesh and the disaggregated split (its fake
    process group never meets phase 13's NCCL world; meta tensors), and
    (e) the provision_capacity example, which runs no model."""
    code = ("import sys\n"
            "from repro_torch.launch import dryrun\n"
            "from repro_torch.examples import provision_capacity\n"
            f"a = dryrun.main(['--arch', '{ARCH}', '--mesh', 'single', "
            f"'--force', '--out', '{out_dir}'])\n"
            f"b = dryrun.main(['--disagg', '--arch', '{ARCH}', '--out', "
            f"'{out_dir}'])\n"
            "c = provision_capacity.main([])\n"
            "sys.exit(a or b or c)\n")
    root = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def stop(proc) -> None:
    """Kill ``proc`` if it still runs, and reap it."""
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()


def host_jobs_report(smi, proc, out_dir: pathlib.Path) -> dict:
    """Phase 14(c)'s records and (e)'s provision_capacity lines, once the
    subprocess has ended."""
    try:
        log, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
    finally:
        stop(proc)
    lines = log.splitlines()
    print("phase 14(c) dry run log: " + " | ".join(
        ln for ln in lines if "__" in ln), flush=True)
    print("phase 14(e) provision_capacity (no device): " + " | ".join(
        lines[-4:]), flush=True)
    check(proc.returncode == 0, f"phase 14(c, e): the host jobs exited "
          f"{proc.returncode}: {lines[-20:]}")
    check("grows for the larger pool: True; shrinks for the hot one: True"
          in lines, "phase 14(e): provision_capacity's invariant line")
    out = {}
    for shape in DRYRUN_SHAPES:
        rec = json.loads((out_dir / f"{ARCH}__{shape}__single.json")
                         .read_text())
        check(rec["status"] == "OK", f"phase 14(c) {shape}: {rec}")
        r, m = rec["roofline"], rec["memory"]
        an = m["analytic"]
        out[shape] = {"peak_gib_analytic": m["peak_per_device"] / 2**30,
                      "fits_80g": m["fits_80g"],
                      **{k + "_gib": an[k] / 2**30 for k in (
                          "params", "params_as_run", "grads",
                          "at_use_gather", "logits_as_run", "opt_state",
                          "workspace", "total", "total_as_run")},
                      "bottleneck": r["bottleneck"],
                      "roofline_fraction": r["roofline_fraction"],
                      "t_compute_ms": 1e3 * r["t_compute"],
                      "t_memory_ms": 1e3 * r["t_memory"],
                      "t_collective_ms": 1e3 * r["t_collective"],
                      "trace_s": rec["trace_s"], "chips": r["chips"]}
    split = json.loads((out_dir / f"{ARCH}__decode_32k__single__disagg.json")
                       .read_text())
    check(split["status"] == "OK", f"phase 14(c) disagg: {split}")
    out["disagg"] = {k: split[k] for k in (
        "instance_mesh", "server_mesh", "transfer_bytes_per_layer")}
    print("phase 14(c) dry run of the production mesh (one rank of 256, "
          "meta tensors; the steps in the reference's parameter layout): "
          + json.dumps(out) + f"; card {smi}", flush=True)
    for shape in DRYRUN_SHAPES:
        check(out[shape]["params_as_run_gib"] == out[shape]["params_gib"],
              f"phase 14(c) {shape}: the parameters as run are not the "
              f"reference's layout: {out[shape]}")
    check(out["train_4k"]["fits_80g"],
          f"phase 14(c): train_4k does not fit a card: {out['train_4k']}")
    return out


def run_example(name: str, argv) -> tuple:
    """(exit code, printed lines) of ``repro_torch.examples.<name>``'s
    ``main(argv)`` run in this process."""
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue().splitlines()


def examples_cell(torch, smi) -> dict:
    """Phase 14(e) on the card: serve_disaggregated's model part at ARCH's
    widths, depth 2 (coupled == disaggregated under mid-decode admission,
    its invariant line held; the cancellation; the provisioning demo) and
    train_lora's three steps. Its S-LoRA vs InfiniLoRA table runs no model
    (the analytic plane, ~20 s of host time, ``tests/test_torch_examples.py``
    runs it) and provision_capacity runs in the host jobs' subprocess."""
    from repro_torch.examples import serve_disaggregated as sd
    from repro_torch.obs.clock import wall_time

    out = {"seconds": {}}
    t0 = wall_time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ok = sd.functional_demo(torch.device("cuda"), layers=2)
        sd.provisioning_demo()
    lines = buf.getvalue().splitlines()
    out["seconds"]["serve_disaggregated"] = wall_time() - t0
    keep = [ln for ln in lines if ln.startswith(("  rid=", "tokens ident",
                                                 "  qwen3", "min cache"))]
    print("phase 14(e) serve_disaggregated (depth 2, full width): "
          + " | ".join(keep) + f"; card {smi}", flush=True)
    check(ok and "tokens identical across architectures: True" in lines,
          "phase 14(e): serve_disaggregated's planes or its cancellation")
    out["serve_disaggregated"] = True
    free_device(torch)
    t0 = wall_time()
    rc, lines = run_example("train_lora", ["--device", "cuda", "--steps",
                                           "3"])
    out["seconds"]["train_lora"] = wall_time() - t0
    print("phase 14(e) train_lora: " + " | ".join(lines) + f"; card {smi}",
          flush=True)
    losses = [float(ln.rsplit(" ", 1)[1]) for ln in lines
              if ln.startswith("tenant ")]
    check(rc == 0 and losses and all(math.isfinite(x) for x in losses),
          f"phase 14(e): train_lora exited {rc}: {lines}")
    out["train_lora_losses"] = losses
    print("phase 14(e) seconds: " + json.dumps(out["seconds"]), flush=True)
    return out


def analysis_phase(torch, smi, proc, dry_dir: pathlib.Path) -> None:
    """Phase 14's (c), (d) and (e); (a) and (b) ran in the transport phase
    and in phase 13's baseline, and the host jobs ``proc`` (the dry run,
    provision_capacity) have run in their subprocess since phase 12
    began."""
    from repro_torch.analysis import roofline
    from repro_torch.obs.clock import wall_time

    t0 = wall_time()
    PHASE14["e"] = examples_cell(torch, smi)
    PHASE14["seconds"]["e"] = wall_time() - t0
    t1 = wall_time()
    PHASE14["c"] = host_jobs_report(smi, proc, dry_dir)
    PHASE14["seconds"]["c_wait"] = wall_time() - t1
    worst = max(BOUND_CHECKS, key=lambda wc: wc[1])
    print("phase 14(d) kernel bounds from analysis.roofline: " + json.dumps({
        "bounds": len(BOUND_CHECKS), "max_rel_diff": worst[1],
        "worst": worst[0], "tol": BOUND_TOL,
        "peaks": {"flops": roofline.PEAK_FLOPS, "hbm": roofline.HBM_BW,
                  "link": roofline.LINK_BW}}), flush=True)
    secs = PHASE14["seconds"]
    total = sum(secs.values())
    print(f"phase 14: {total:.1f} s ({json.dumps(secs)})", flush=True)

def _first_layers(tree, n: int):
    """Views of the first ``n`` layers of a layer-stacked tree."""
    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import bgmv, build, fused, gmm, ops, paged, ref
    from repro_torch.kernels import sgmv
    from repro_torch.obs.clock import wall_time

    # the plain versions contract in f32: keep them IEEE f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = wall_time()
    smi = nvidia_smi()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = wall_time()
    build.build(build.sources())
    print(f"kernel build: {wall_time() - t0:.1f} s for {build.sources()}",
          flush=True)
    if sys.argv[1:] == ["--only", "13"]:
        spmd_phase(torch, smi)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    for name, log in build.BUILD_LOGS.items():
        print(f"[nvcc {name}] " + " | ".join(
            ln.strip() for ln in log.splitlines() if "Used" in ln or
            "spill" in ln), flush=True)

    counters = {"paged_attention": paged.paged_attention,
                "bgmv_expert": bgmv.bgmv_expert, "bgmv": bgmv.bgmv,
                "bgmv_ranked": bgmv.bgmv_ranked, "sgmv": sgmv.sgmv,
                "sgmv_ranked": sgmv.sgmv_ranked,
                "fused_sgmv": fused.fused_sgmv,
                "fused_sgmv_ranked": fused.fused_sgmv_ranked, "gmm": gmm.gmm}
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    pa = paged_phase(torch, paged, ref, flush)
    hk = hook_phase(torch, bgmv, ref, flush)
    bg = bgmv_phase(torch, bgmv, ref, flush)
    gm = gmm_phase(torch, gmm, ref, flush)
    lora = lora_path_phase(torch, ops, ref, counters, flush)
    repairs = repair_phase(torch, sgmv, fused, ref)
    launches, model, coupled_tokens = main_paths(torch, ops, paged, bgmv,
                                                 ref, counters)
    fused_tokens, fused_prof = transport_phase(torch, ops, smi, *model)
    cfg, params, _ = model
    launches.update(front_door_phase(torch, counters, smi, cfg, params,
                                     fused_tokens, coupled_tokens))
    launches["elastic"] = elastic_phase(torch, counters, smi, flush, cfg,
                                        params, fused_prof, hk, lora[1])
    launches["mesh"] = mesh_phase(torch, ops, ref, counters, flush, smi,
                                  *model, fused_tokens)
    del model, cfg, params
    free_device(torch)
    launches.update(families_phase(torch, ops, ref, counters, flush, smi))
    launches.update(static_phase(torch, ops, ref, counters, smi))
    dry_dir = pathlib.Path(tempfile.mkdtemp())
    proc = host_jobs_start(dry_dir)  # phase 14(c, e), on the host's cores
    try:
        train_grads, launches["train"] = train_phase(
            torch, ops, ref, counters, flush, smi)
        free_device(torch)
        launches["spmd"] = spmd_phase(torch, smi)
        free_device(torch)
        analysis_phase(torch, smi, proc, dry_dir)
    finally:
        stop(proc)
        shutil.rmtree(dry_dir, ignore_errors=True)

    # "launches": the coupled plane's run for rows 1-3 and gmm, the
    # LoRA-kernel path's run for rows 4-8; each path's counted run in
    # "launches_by_plane"
    def launch_counts(name):
        return {"launches": launches["coupled"][name],
                "launches_by_plane": {**{p: n[name]
                                         for p, n in launches.items()},
                                      "lora_kernels": lora[0][name]}}

    up, dn = hk["up"], hk["down"]
    kernels = [
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged.py:93",
             **launch_counts("paged_attention"), **pa["context_2048"],
             shape="2048-token contexts (nb 128)",
             serving=pa["serving"], window_512=pa["window_512"]),
        dict(name="bgmv_expert", route="cuda",
             source="src/repro_torch/csrc/bgmv_expert.cu",
             replaces="src/repro/kernels/bgmv.py:138",
             **launch_counts("bgmv_expert"),
             max_abs_err=max(up["max_abs_err"], dn["max_abs_err"]),
             ms=up["ms"] + dn["ms"], plain_ms=up["plain_ms"] + dn["plain_ms"],
             bound_ms=up["bound_ms"] + dn["bound_ms"], bound_by="bytes"
             if up["bound_by"] == dn["bound_by"] == "bytes" else "operations",
             library_ms=None, per_layer="one up hook + one down hook",
             bound_ms_pool_rank=up["bound_ms_pool_rank"]
             + dn["bound_ms_pool_rank"], hooks=hk),
        dict(name="bgmv", route="cuda", source="src/repro_torch/csrc/bgmv.cu",
             replaces="src/repro/kernels/bgmv.py:48",
             **launch_counts("bgmv"),
             max_abs_err=max(t["max_abs_err"] for t in bg.values()),
             ms=sum(t["ms"] for t in bg.values()),
             plain_ms=sum(t["plain_ms"] for t in bg.values()),
             bound_ms=sum(t["bound_ms"] for t in bg.values()),
             bound_by="bytes" if all(t["bound_by"] == "bytes"
                                     for t in bg.values()) else "operations",
             library_ms=None, per_layer="q + k + v + o deltas",
             targets=bg),
        *lora_rows(lora, launches, gm, repairs),
    ]
    for row in kernels:     # phase 12: forward + backward at the fine-tune's
        if row["name"] in train_grads:
            row["train"] = train_grads[row["name"]]
    print(json.dumps({"kernels": kernels}))
    print(f"script: {wall_time() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
