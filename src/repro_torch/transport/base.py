"""Transport plane contract and the step both planes run, the counterpart
of ``repro.transport.base`` (paper §5 "GPU-initiated communication").

A *transport* is the piece of the disaggregated data path that moves the
per-layer LoRA hook work between the LLM instance and the LoRA-Server pool
during one continuous-batching decode step. Two planes implement it:

  HostTransport   (transport/host.py)  : every MoE layer calls back into
                  Python twice (2 x n_layers hook dispatches a step, each
                  engaging one launch per replica), so the host launches
                  every kernel of the step one by one
  FusedTransport  (transport/fused.py) : the adapter -> slot table and the
                  replica routing live in device buffers of fixed address
                  (rewritten only when residency changes), so the whole
                  step is one captured CUDA graph per shape bucket: one
                  host dispatch a step

Both take the step's inputs as host arrays (the engine builds them there)
and return the greedy tokens as a host array. The KV is written in place.
The reference's ``kv_donating_jit``, ``gather_rows`` and ``scatter_rows``
have no counterpart: the dense layout's row gather and scatter are plain
functions here (``gather_rows``, ``scatter_rows``), and ``decode_tokens`` is
the step both planes run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Protocol

import numpy as np
import torch

from repro_torch.core import disagg as disagg_mod


@dataclasses.dataclass
class TransportStats:
    """Launch accounting for one transport. ``host_dispatches`` counts the
    launches the host starts on the decode path; ``lut_uploads`` counts
    residency-change uploads (off the per-token path); ``hook_dispatches``
    isolates the LoRA-hook share of the launches."""
    transport: str = "host"
    steps: int = 0                  # decode steps served
    host_dispatches: int = 0        # host-initiated launches on decode path
    hook_dispatches: int = 0        # the 2 x n_layers server-hook share
    lut_uploads: int = 0            # residency/LUT device refreshes
    # effective-rank telemetry: the per-row rank the hook compute PAID
    # (true slot rank when rank-aware, the padded pool rank otherwise),
    # accumulated over every active row of every decode step
    pool_rank: int = 0              # padded slot-pool rank (the baseline)
    active_rank_rows: int = 0       # active rows observed
    active_rank_sum: int = 0        # summed paid rank over those rows
    max_active_rank: int = 0

    @property
    def device_programs(self) -> int:
        """Device programs run on the decode path: the host dispatch count
        (the CUDA graph of a fused step is one)."""
        return self.host_dispatches

    def per_step(self) -> float:
        return self.host_dispatches / max(self.steps, 1)

    def mean_active_rank(self) -> float:
        return self.active_rank_sum / self.active_rank_rows \
            if self.active_rank_rows else 0.0

    def rank_flop_savings(self) -> float:
        """Fraction of the padded hook FLOPs the rank bound eliminated:
        1 - mean_paid_rank / pool_rank (0 when nothing observed)."""
        if not (self.pool_rank and self.active_rank_rows):
            return 0.0
        return 1.0 - self.mean_active_rank() / self.pool_rank

    def observe_ranks(self, server, adapter_ids) -> None:
        """Bill one step's active rows at the rank the hook compute pays:
        the slot's TRUE rank when ``server`` is rank-aware, else its padded
        pool rank. ``server``: a ``ServerPool`` or a bare ``LoRAServer``;
        ``adapter_ids``: the step's host-side ids."""
        ids = np.asarray(adapter_ids)
        active = ids[ids >= 0]
        if active.size == 0:
            return
        pool_rank = int(getattr(server, "pool_rank", 0) or
                        getattr(server, "r", 0))
        tr = getattr(server, "true_rank", None)
        if tr is not None and getattr(server, "rank_aware", True):
            ranks = np.array([tr(int(a)) for a in active])
            ranks = np.where(ranks > 0, ranks, pool_rank)
        else:
            ranks = np.full(active.size, pool_rank)
        self.active_rank_rows += int(active.size)
        self.active_rank_sum += int(ranks.sum())
        self.max_active_rank = max(self.max_active_rank, int(ranks.max()))
        self.pool_rank = max(self.pool_rank, pool_rank)

    def as_dict(self) -> Dict[str, float]:
        return {
            "transport": self.transport,
            "steps": self.steps,
            "host_dispatches": self.host_dispatches,
            "device_programs": self.device_programs,
            "hook_dispatches": self.hook_dispatches,
            "lut_uploads": self.lut_uploads,
            "host_dispatches_per_step": round(self.per_step(), 3),
            "mean_active_rank": round(self.mean_active_rank(), 3),
            "max_active_rank": self.max_active_rank,
            "rank_flop_savings": round(self.rank_flop_savings(), 4),
        }


class Transport(Protocol):
    """One disaggregated decode step: batch in, token ids out, the KV
    written in place.

    toks (B, 1), pos_vec (B,), adapter_ids (B,): host int arrays;
    ``block_table`` (B, nb) selects the paged layout, ``sel``/``scatter_idx``
    (B,) drive the dense slab's row gather and scatter (a scatter index
    past the slab drops the row). Returns (tokens (B,) int64, k, v)."""

    stats: TransportStats

    def decode_step(self, params, cfg, k, v, toks, pos_vec, adapter_ids,
                    lora_scale, *, sel=None, scatter_idx=None,
                    block_table=None): ...

    def forget_kv(self, k, v) -> None:
        """Drop what the plane keeps for the KV buffers ``k``/``v`` (an
        engine releasing them: an instance retired)."""


def make_transport(name: str, server, n_adapters: Optional[int] = None
                   ) -> Transport:
    """Build the named transport plane over ``server`` (a ``ServerPool``
    or a single ``LoRAServer``)."""
    from repro_torch.transport.fused import FusedTransport
    from repro_torch.transport.host import HostTransport
    if name == "host":
        return HostTransport(server)
    if name == "fused":
        return FusedTransport(server, n_adapters=n_adapters)
    raise ValueError(f"unknown transport {name!r} "
                     f"(expected 'host' or 'fused')")


# ------------------------------------------------------------------ #
# the step both planes run                                            #
# ------------------------------------------------------------------ #
def gather_rows(k, v, sel):
    """The dense slab's rows of slots ``sel`` (B,): (L, B, S, KV, hd)
    copies of k and v."""
    idx = sel.long()
    return k[:, idx], v[:, idx]


def scatter_rows(k, v, k_rows, v_rows, idx) -> None:
    """Write row b of k_rows/v_rows (L, B, S, KV, hd) to slot idx[b] of the
    slab k/v (L, n, S, KV, hd), in place; a row whose index lies outside
    [0, n) writes nothing (the reference's ``mode="drop"``). Torch has no
    drop mode, and reading which rows write would sync the host: a dropped
    row is sent to the first writing row's slot with that row's values, so
    duplicate indices carry equal values (``layers.py``'s paged write does
    the same). With no writing row, every row rewrites slot 0 with what it
    holds. ``first`` is a 1-element index: a 0-d one would be read on the
    host."""
    n = k.shape[1]
    idx = idx.long()
    ok = (idx >= 0) & (idx < n)
    any_ok = ok.any()
    first = torch.argmax(ok.to(torch.int32), dim=0, keepdim=True)
    target = torch.where(ok, idx, torch.where(any_ok, idx[first], 0))
    keep = ok[None, :, None, None, None]
    for dst, rows in ((k, k_rows), (v, v_rows)):
        fill = torch.where(any_ok, rows[:, first].to(dst.dtype),
                           dst[:, :1])
        dst[:, target] = torch.where(keep, rows.to(dst.dtype), fill)


def decode_tokens(params, cfg, k, v, toks, pos_vec, server, adapter_ids,
                  lora_scale, *, sel=None, scatter_idx=None,
                  block_table=None):
    """One disaggregated decode step on device tensors -> greedy tokens
    (B,) on the device; the KV (paged pool, or the dense slab through
    ``sel``/``scatter_idx``) is written in place. ``server``: anything with
    the LoRA Server's ``compute`` contract."""
    if block_table is not None:
        logits, _, _ = disagg_mod.disagg_decode_step_slots(
            params, cfg, k, v, toks, pos_vec, server, adapter_ids,
            lora_scale, block_table=block_table)
    else:
        k_rows, v_rows = gather_rows(k, v, sel)
        logits, k_rows, v_rows = disagg_mod.disagg_decode_step_slots(
            params, cfg, k_rows, v_rows, toks, pos_vec, server, adapter_ids,
            lora_scale)
        scatter_rows(k, v, k_rows, v_rows, scatter_idx)
    return torch.argmax(logits[:, : cfg.vocab_size], dim=-1)


def eager_step(params, cfg, k, v, toks, pos_vec, server, adapter_ids,
               lora_scale, sel=None, scatter_idx=None, block_table=None):
    """``decode_tokens`` on the host arrays of one step, moved to the KV's
    device, run eagerly -> greedy tokens (B,) int64 on the host."""
    dev = k.device

    def on_dev(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    tok = decode_tokens(params, cfg, k, v, on_dev(toks), on_dev(pos_vec),
                        server, on_dev(adapter_ids), lora_scale,
                        sel=on_dev(sel), scatter_idx=on_dev(scatter_idx),
                        block_table=on_dev(block_table))
    return np.asarray(tok.tolist(), np.int64)
