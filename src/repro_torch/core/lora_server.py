"""The disaggregated LoRA Server (paper §3-§5), the counterpart of
``repro.core.lora_server``.

The server owns a slot pool of resident adapters (capacity M) and computes
the LoRA deltas of remote LLM instances, twice per MoE layer:

  hook "up"   : rows x (R, d)  -> fused gate|up deltas (R, 2*ff)
  hook "down" : rows h (R, ff) -> down delta (R, d)

Flat path (no mesh): slot pools layer-major within a pipeline stage,
(y, L_stage, M, E, ...), on one device, as in the reference. EP_x-PP_y
path (``mesh`` of axes ("ep", "pp"), ``make_server_mesh``): experts
block-sharded over "ep", layers interleaved over "pp" stages (layer l ->
stage l % y). Position (e, s) holds its own contiguous block
(L_stage, M, E/x, ...): stage s's layers, experts [e*E/x, (e+1)*E/x). A
hook's rows arrive expert-major (the dispatch's E*C rows), so its x equal
row blocks are the aligned expert partition (paper §4.1): block e runs on
position (e, l % y) with local expert ids. The reference adds the other
stages' exact zeros (a psum over "pp"); the port computes only the owning
stage, the same values up to the sign of a zero.

Each slot carries its adapter's true rank, and the hook bounds every row's
contraction at it through the mask (col % r) < rank. ``compute`` runs the
hook kernel (``kernels.ops``).
The id -> slot table and the slot ranks live on the device in buffers of
fixed address, written in place on every insert and evict (a table that
must grow gets a new buffer), so a hook call needs no round trip to the
host. ``mutations`` counts residency and weight changes: the fused
transport re-reads the slot tables only when it moved.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.adapter import AdapterPool
from repro_torch.core.placement import Placement
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh, grid, visible_cards
from repro_torch.models.model import resolve_device

_LUT_MIN = 64   # initial id -> slot table length
POOL_NAMES = ("up_A", "up_B", "down_A", "down_B")


def make_server_mesh(x: int, y: int, devices=None) -> Mesh:
    """The LoRA Server's EP_x-PP_y grid, axes ("ep", "pp"): the first x*y
    visible cards by default, else ``devices`` (one device fills every
    position)."""
    if devices is None:
        devices = visible_cards(x * y, f"a server mesh ({x}, {y})")
    return Mesh(grid(devices, (x, y)), ("ep", "pp"))


@dataclasses.dataclass
class ServerConfig:
    m: int                       # server device count
    x: int                       # EP degree
    y: int                       # PP stages (x*y == m)
    cache_slots: int             # M: resident adapter capacity
    rank: int


class LoRAServer:
    """Slot table + slot pools + the hook computation: the flat path, or
    the EP_x-PP_y path over ``mesh`` (whose first position holds the slot
    tables)."""

    def __init__(self, model_cfg, server_cfg: ServerConfig,
                 dtype=torch.bfloat16, device=None,
                 mesh: Optional[Mesh] = None):
        self.cfg = model_cfg
        self.scfg = server_cfg
        self.mesh = mesh
        E = max(model_cfg.n_experts, 1)
        L, M, r = model_cfg.n_layers, server_cfg.cache_slots, server_cfg.rank
        d, ff = model_cfg.d_model, model_cfg.d_ff
        self.E, self.L, self.M, self.r = E, L, M, r
        self.x, self.y = server_cfg.x, server_cfg.y
        self.L_stage = -(-L // self.y)
        self.n_up = 2 if model_cfg.gated_mlp else 1
        ru = self.n_up * r
        # the fused "up" operator has rank n_up*r (block-diagonal B)
        shapes = {"up_A": (d, ru), "up_B": (ru, self.n_up * ff),
                  "down_A": (ff, r), "down_B": (r, d)}
        if mesh is None:
            self.device = resolve_device(device)
            lead = (self.y, self.L_stage, M, E)
            self.pool = {n: torch.zeros(lead + s, dtype=dtype,
                                        device=self.device)
                         for n, s in shapes.items()}
        else:
            if tuple(mesh.devices.shape) != (self.x, self.y) or \
                    tuple(mesh.axis_names) != ("ep", "pp"):
                raise ValueError(f"server mesh {mesh.shape} is not the "
                                 f"config's ep={self.x} x pp={self.y}")
            if E % self.x:
                raise ValueError(f"{E} experts do not split over ep="
                                 f"{self.x}")
            self.device = mesh.first
            self.E_loc = E // self.x
            lead = (self.L_stage, M, self.E_loc)
            # position (e, s): stage s's layers, expert block e
            self.blocks = {
                (e, s): {n: torch.zeros(lead + sh, dtype=dtype,
                                        device=mesh.devices[e, s])
                         for n, sh in shapes.items()}
                for e in range(self.x) for s in range(self.y)}
        self.slot_of: Dict[int, int] = {}
        self.free_slots = list(range(M))
        # per-slot TRUE rank (0 = empty slot), host copy and device copy
        self.slot_ranks = [0] * M
        self._ranks_dev = torch.zeros(M, dtype=torch.int32,
                                      device=self.device)
        # id -> slot on the device, -1 = not resident; grown by doubling
        self._lut = torch.full((_LUT_MIN,), -1, dtype=torch.int32,
                               device=self.device)
        # False pins the padded pool-rank path (the bit-identity baseline)
        self.rank_aware = True
        # monotone residency/weight mutation counter (fused transport's
        # fingerprint), and per slot the number of weight writes (the
        # fused transport copies only the slots whose count moved)
        self.mutations = 0
        self.slot_writes = [0] * M

    @property
    def pool_rank(self) -> int:
        return self.r

    # ------------------------- residency --------------------------- #
    def is_resident(self, adapter_id: int) -> bool:
        return adapter_id in self.slot_of

    def true_rank(self, adapter_id: int) -> int:
        """TRUE rank of a resident adapter (0 = not resident)."""
        slot = self.slot_of.get(adapter_id)
        return self.slot_ranks[slot] if slot is not None else 0

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
        if adapter_id >= self._lut.shape[0]:
            n = self._lut.shape[0]
            while n <= adapter_id:
                n *= 2
            grown = torch.full((n,), -1, dtype=torch.int32,
                               device=self.device)
            grown[: self._lut.shape[0]] = self._lut
            self._lut = grown
        self._lut[adapter_id] = slot
        self._ranks_dev[slot] = self.slot_ranks[slot]
        self.mutations += 1
        if tensors is not None:
            self._write_slot(slot, tensors)
        return slot

    def evict(self, adapter_id: int) -> None:
        slot = self.slot_of.pop(adapter_id)
        self.free_slots.append(slot)
        self.slot_ranks[slot] = 0
        self._lut[adapter_id] = -1
        self._ranks_dev[slot] = 0
        self.mutations += 1

    def _write_slot(self, slot: int, tensors) -> None:
        for name in POOL_NAMES:
            src = tensors[name]
            for l in range(self.L):
                s, li = l % self.y, l // self.y
                if self.mesh is None:
                    self.pool[name][s, li, slot].copy_(src[l])
                    continue
                for e in range(self.x):
                    e0 = e * self.E_loc
                    self.blocks[(e, s)][name][li, slot].copy_(
                        src[l, e0:e0 + self.E_loc])
        self.slot_writes[slot] += 1
        self.mutations += 1

    # --------------------------- lookup ---------------------------- #
    def resolve_slots(self, adapter_ids: torch.Tensor) -> torch.Tensor:
        """(R,) global adapter ids -> resident slot ids, -1 for absent or
        inactive rows (on the server's device)."""
        n = self._lut.shape[0]
        ids = adapter_ids.long()
        ok = (ids >= 0) & (ids < n)
        return torch.where(ok, self._lut[ids.clamp(0, n - 1)], -1)

    def row_ranks(self, slots: torch.Tensor) -> torch.Tensor:
        """Per-row true rank of resolved slots; inactive rows get the pool
        rank (their delta is zero anyway), and every row does when
        ``rank_aware`` is off."""
        if not self.rank_aware:
            return torch.full_like(slots, self.r, dtype=torch.int32)
        ranks = self._ranks_dev[slots.long().clamp_min(0)]
        return torch.where((slots >= 0) & (ranks > 0), ranks,
                           self.r).to(torch.int32)

    def cache_bytes(self) -> int:
        pools = [self.pool] if self.mesh is None else self.blocks.values()
        return sum(a.numel() * a.element_size() for p in pools
                   for a in p.values())

    def placement(self) -> Placement:
        return Placement.make("hybrid", self.scfg.m, self.M, self.L, self.E,
                              x=self.x)

    # --------------------------- compute --------------------------- #
    def compute(self, hook: str, layer: int, rows, adapter_ids, expert_ids):
        """rows: (R, d_in); adapter_ids: (R,) global ids (resolved to slots
        here); expert_ids: (R,). Returns the deltas (R, d_out) f32."""
        stage, li = layer % self.y, layer // self.y
        slots = self.resolve_slots(adapter_ids).to(torch.int32)
        a, b = ("up_A", "up_B") if hook == "up" else ("down_A", "down_B")
        eids = expert_ids.to(torch.int32)
        ranks = self.row_ranks(slots)
        if self.mesh is None:
            return ops.bgmv_expert(rows.contiguous(), self.pool[a][stage, li],
                                   self.pool[b][stage, li], slots, eids,
                                   ranks, self.r)
        # the aligned expert partition: row block e holds experts
        # [e*E_loc, (e+1)*E_loc) and runs on the owning stage's position
        R = rows.shape[0]
        if R % self.x:
            raise ValueError(f"{R} hook rows do not split over ep={self.x}")
        n, home = R // self.x, rows.device
        out = torch.empty((R, self.blocks[(0, stage)][b].shape[-1]),
                          dtype=torch.float32, device=home)
        local = eids % self.E_loc
        for e in range(self.x):
            blk, dev = self.blocks[(e, stage)], self.mesh.devices[e, stage]
            part = slice(e * n, (e + 1) * n)
            call = (rows[part].to(dev).contiguous(), blk[a][li], blk[b][li],
                    slots[part].to(dev), local[part].to(dev),
                    ranks[part].to(dev), self.r)
            if dev == home:
                ops.bgmv_expert(*call, out=out[part])
            else:
                out[part].copy_(ops.bgmv_expert(*call))
        return out


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
