"""The disaggregated LoRA Server (paper §3-§5), the counterpart of the flat
(single-device) path of ``repro.core.lora_server``.

The server owns a slot pool of resident adapters (capacity M) and computes
the LoRA deltas of remote LLM instances, twice per MoE layer:

  hook "up"   : rows x (R, d)  -> fused gate|up deltas (R, 2*ff)
  hook "down" : rows h (R, ff) -> down delta (R, d)

Slot pools are layer-major within a pipeline stage, (y, L_stage, M, E, ...),
as in the reference; each slot carries its adapter's true rank, and the
hook bounds every row's contraction at it through the mask
(col % r) < rank. ``compute`` runs the hook kernel (``kernels.ops``).
The id -> slot table and the slot ranks live on the device, so a hook
call needs no round trip to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.adapter import AdapterPool
from repro_torch.kernels import ops
from repro_torch.models.model import resolve_device


@dataclasses.dataclass
class ServerConfig:
    m: int                       # server device count
    x: int                       # EP degree
    y: int                       # PP stages (x*y == m)
    cache_slots: int             # M: resident adapter capacity
    rank: int


class LoRAServer:
    """Slot table + slot pools + the hook computation (flat path)."""

    def __init__(self, model_cfg, server_cfg: ServerConfig,
                 dtype=torch.bfloat16, device=None):
        if server_cfg.x != 1 or server_cfg.m != server_cfg.y:
            raise ValueError("the port's server runs the flat path only "
                             "(x = 1, m = y); the mesh path comes later")
        self.cfg = model_cfg
        self.scfg = server_cfg
        self.device = resolve_device(device)
        E = max(model_cfg.n_experts, 1)
        L, M, r = model_cfg.n_layers, server_cfg.cache_slots, server_cfg.rank
        d, ff = model_cfg.d_model, model_cfg.d_ff
        self.E, self.L, self.M, self.r = E, L, M, r
        self.y = server_cfg.y
        self.L_stage = -(-L // self.y)
        self.n_up = 2 if model_cfg.gated_mlp else 1
        ru = self.n_up * r
        lead = (self.y, self.L_stage, M, E)

        def zeros(*shape):
            return torch.zeros(lead + shape, dtype=dtype, device=self.device)

        # the fused "up" operator has rank n_up*r (block-diagonal B)
        self.pool = {"up_A": zeros(d, ru), "up_B": zeros(ru, self.n_up * ff),
                     "down_A": zeros(ff, r), "down_B": zeros(r, d)}
        self.slot_of: Dict[int, int] = {}
        self.free_slots = list(range(M))
        # per-slot TRUE rank (0 = empty slot), host copy and device copy
        self.slot_ranks = [0] * M
        self._ranks_dev: Optional[torch.Tensor] = None
        self._lut: Optional[torch.Tensor] = None  # id -> slot, on device

    # ------------------------- residency --------------------------- #
    def insert(self, adapter_id: int, tensors=None,
               rank: Optional[int] = None) -> int:
        """Claim a slot for ``adapter_id`` and write ``tensors`` into it
        (``{'up_A': (L, E, d, 2r), ...}``). ``rank`` is the TRUE rank
        (default: the pool rank)."""
        if adapter_id in self.slot_of:
            return self.slot_of[adapter_id]
        if not self.free_slots:
            raise RuntimeError("LoRA server cache full")
        slot = self.free_slots.pop(0)
        self.slot_of[adapter_id] = slot
        self.slot_ranks[slot] = int(rank) if rank else self.r
        self._lut = self._ranks_dev = None
        if tensors is not None:
            self._write_slot(slot, tensors)
        return slot

    def evict(self, adapter_id: int) -> None:
        slot = self.slot_of.pop(adapter_id)
        self.free_slots.append(slot)
        self.slot_ranks[slot] = 0
        self._lut = self._ranks_dev = None

    def _write_slot(self, slot: int, tensors) -> None:
        for name, buf in self.pool.items():
            src = tensors[name]
            for l in range(self.L):
                buf[l % self.y, l // self.y, slot].copy_(src[l])

    # --------------------------- lookup ---------------------------- #
    def resolve_slots(self, adapter_ids: torch.Tensor) -> torch.Tensor:
        """(R,) global adapter ids -> resident slot ids, -1 for absent or
        inactive rows, on the ids' device."""
        if self._lut is None or self._lut.device != adapter_ids.device:
            lut = [-1] * (max(self.slot_of, default=0) + 2)
            for aid, slot in self.slot_of.items():
                lut[aid] = slot
            self._lut = torch.tensor(lut, dtype=torch.int32,
                                     device=adapter_ids.device)
        n = self._lut.shape[0]
        ids = adapter_ids.long()
        ok = (ids >= 0) & (ids < n)
        return torch.where(ok, self._lut[ids.clamp(0, n - 1)], -1)

    def row_ranks(self, slots: torch.Tensor) -> torch.Tensor:
        """Per-row true rank of resolved slots; inactive rows get the pool
        rank (their delta is zero anyway)."""
        if self._ranks_dev is None or self._ranks_dev.device != slots.device:
            self._ranks_dev = torch.tensor(self.slot_ranks, dtype=torch.int32,
                                           device=slots.device)
        ranks = self._ranks_dev[slots.long().clamp_min(0)]
        return torch.where((slots >= 0) & (ranks > 0), ranks,
                           self.r).to(torch.int32)

    # --------------------------- compute --------------------------- #
    def compute(self, hook: str, layer: int, rows, adapter_ids, expert_ids):
        """rows: (R, d_in); adapter_ids: (R,) global ids (resolved to slots
        here); expert_ids: (R,). Returns the deltas (R, d_out) f32."""
        stage, li = layer % self.y, layer // self.y
        slots = self.resolve_slots(adapter_ids).to(torch.int32)
        A = self.pool["up_A" if hook == "up" else "down_A"][stage, li]
        B = self.pool["up_B" if hook == "up" else "down_B"][stage, li]
        return ops.bgmv_expert(rows.contiguous(), A, B, slots,
                               expert_ids.to(torch.int32),
                               self.row_ranks(slots), self.r)


def pool_tensors_from_adapter(pool: AdapterPool, adapter_id: int):
    """One adapter's server-side tensors, from an AdapterPool: gate and up
    have independent A's, so they fuse into one rank-2r operator with a
    block-diagonal B, and one server product yields [d_gate, d_up]."""
    cfg = pool.cfg

    def tgt(name):
        t = pool.tensors[name]
        A, B = t["A"][:, adapter_id], t["B"][:, adapter_id]
        if not cfg.is_moe:  # add a singleton expert dim
            A, B = A[:, None], B[:, None]
        return A, B

    up_A, up_B = tgt("up")
    if cfg.gated_mlp and "gate" in pool.tensors:
        g_A, g_B = tgt("gate")
        up_A = torch.cat([g_A, up_A], dim=-1)                 # (L,E,d,2r)
        up_B = torch.cat(
            [torch.cat([g_B, torch.zeros_like(g_B)], dim=-1),
             torch.cat([torch.zeros_like(up_B), up_B], dim=-1)],
            dim=-2)                                           # (L,E,2r,2ff)
    dn_A, dn_B = tgt("down")
    return {"up_A": up_A, "up_B": up_B, "down_A": dn_A, "down_B": dn_B}
