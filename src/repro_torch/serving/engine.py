"""Slot engine for multi-LoRA decode, the counterpart of
``repro.serving.engine.Engine``, in both adapter planes and both KV
layouts:

  disaggregated : ``server`` given (a ``LoRAServer`` or a ``ServerPool``);
                  the model stays LoRA-free and the LoRA Server computes
                  the MoE hooks' deltas. The engine never dispatches hooks
                  itself: its ``transport`` plane runs the step, "host"
                  (per-hook host dispatch) or "fused" (the whole step as
                  one CUDA graph a bucket; see ``transport/``)
  coupled       : ``server=None``; the adapters of a static ``pool`` are
                  applied inside the model (the S-LoRA baseline)
  paged         : one pool of pages shared by all slots, pages allocated
                  as positions are written and freed at eviction
  dense         : ``EngineConfig(paged=False)``; a slab of max_len rows per
                  slot, gathered into the step's rows and scattered back

Under a mesh (``mesh_ctx``, a ``distributed.steps.ExpertParallelCtx``;
disaggregated plane only) the engine cuts the params' expert weights into
the mesh's blocks once (``shard_serve_params``; blocks the params already
hold are kept), so its base expert GEMMs run expert-parallel over the
mesh's devices; the KV lives on the mesh's first device, where the engine
runs.

The engine owns ``n_slots`` persistent decode slots (dense, moe and vlm
models; the KV is made at the first admission). A request is admitted
into a free slot at a step boundary: its prompt, all but the last token,
runs through fixed-width LoRA-free prefill chunks whose KV goes straight
into the slot's pages or rows. ``step()`` decodes one token for every
occupied slot: occupied slots are packed into a power-of-two bucket and
padding rows run with position -1 and adapter -1.

The legacy static-batch API, ``prefill`` / ``decode``, serves every
family (ssm, hybrid and audio only there) and int8 KV
(``EngineConfig.kv_quant``): one batch of prompts at one shared position,
through ``transformer.decode_step`` or, with a server and adapter ids,
``disagg.disagg_decode_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import SLOT_FAMILIES
from repro_torch.core import disagg
from repro_torch.distributed.steps import shard_serve_params
from repro_torch.launch.mesh import COUPLED_UNDER_MESH
from repro_torch.models import cache as cache_mod
from repro_torch.models import transformer
from repro_torch.models.model import resolve_device
from repro_torch.transport.base import make_transport


def _check_plane(cfg, disaggregated: bool) -> None:
    if disaggregated and not cfg.is_moe:
        raise ValueError(f"{cfg.name}: disaggregated hooks target MoE FFNs "
                         f"(paper Fig. 3b); serve the '{cfg.family}' family "
                         f"on the coupled plane")


def check_family(cfg, disaggregated: bool = False) -> None:
    """Refuse, before anything is allocated, a model the slot engine cannot
    serve: a family without a per-slot attention KV cache (the reference's
    message), or a non-MoE model on the disaggregated plane (its hooks sit
    in the MoE FFN)."""
    if cfg.family not in SLOT_FAMILIES:
        raise ValueError(
            f"slot engine requires a per-slot attention KV cache; family "
            f"'{cfg.family}' has none (supported: "
            f"{', '.join(SLOT_FAMILIES)}). Use the legacy prefill/decode "
            f"API for ssm/hybrid/audio models.")
    _check_plane(cfg, disaggregated)


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with the current card's index where it names none."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _bucket(n: int, cap: int) -> int:
    """Next power of two >= n, capped at cap (>= 1)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


@dataclasses.dataclass
class EngineConfig:
    max_len: int = 256
    n_slots: int = 8
    # the port's default layout is paged (the reference's is dense)
    paged: bool = True
    page_size: int = 8
    n_pages: Optional[int] = None  # None -> n_slots * ceil(max_len / page)
    prefill_chunk: int = 16        # rounded up to a page multiple when paged
    kv_quant: bool = False         # int8 KV: the legacy prefill/decode only


@dataclasses.dataclass
class SlotState:
    rid: int
    adapter_id: int
    pos: int            # position of the NEXT token fed to the model
    last_token: int     # next decode input


class Engine:
    """Slot engine. Disaggregated when ``server`` (a ``LoRAServer`` or a
    ``ServerPool``) is given, its deltas multiplied by the scale of the
    ``pool`` its adapters come from (the reference's rule), or by
    ``lora_scale`` without a pool (default 1.0); a ``lora_scale`` that
    disagrees with the pool's is refused. The ``transport`` ("host",
    "fused", or a prebuilt transport shared by several engines) runs its
    decode steps. Coupled otherwise, with the adapters of ``pool`` (an
    AdapterPool; None serves the base model), and no transport. Any family
    takes the legacy ``prefill`` / ``decode``; the slot path
    (``add_request`` / ``step``) refuses the ssm, hybrid and audio ones
    and ``kv_quant`` at the first admission, as the reference."""

    def __init__(self, cfg, params, ecfg: EngineConfig, server=None,
                 lora_scale: Optional[float] = None, device=None, pool=None,
                 transport="host", mesh_ctx=None):
        _check_plane(cfg, disaggregated=server is not None)
        if mesh_ctx is not None:
            if server is None:
                raise ValueError(f"mesh_ctx requires the disaggregated plane "
                                 f"(server=): {COUPLED_UNDER_MESH}")
            params = shard_serve_params(params, mesh_ctx)
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.server = server
        self.pool = pool
        self.transport = None
        if server is not None:
            self.transport = transport if not isinstance(transport, str) \
                else make_transport(transport, server,
                                    n_adapters=pool.n if pool else None)
        if pool is not None and lora_scale is not None \
                and float(lora_scale) != float(pool.scale):
            raise ValueError(f"lora_scale {lora_scale} disagrees with the "
                             f"pool's scale {pool.scale}")
        self.lora_scale = float(pool.scale if pool is not None else
                                1.0 if lora_scale is None else lora_scale)
        self.device = resolve_device(device)
        if mesh_ctx is not None:
            first = mesh_ctx.mesh.first
            if device is not None and _indexed(self.device) != first:
                raise ValueError(f"the engine runs on the mesh's first "
                                 f"device {first}, not {self.device}")
            self.device = first
        self.slots: List[Optional[SlotState]] = [None] * ecfg.n_slots
        self._by_rid: Dict[int, int] = {}
        chunk = max(int(ecfg.prefill_chunk), 1)
        if ecfg.paged:
            ps = int(ecfg.page_size)
            if ps < 1 or ecfg.max_len % ps:
                raise ValueError(f"page_size ({ps}) must divide max_len "
                                 f"({ecfg.max_len})")
            chunk = -(-chunk // ps) * ps
            self.blocks_per_slot = ecfg.max_len // ps
            self.total_pages = ecfg.n_pages if ecfg.n_pages is not None \
                else ecfg.n_slots * self.blocks_per_slot
            self._bt = np.full((ecfg.n_slots, self.blocks_per_slot), -1,
                               np.int32)
            self._free: List[int] = list(range(self.total_pages - 1, -1, -1))
            self.peak_pages = 0
        self._chunk = min(chunk, ecfg.max_len)
        # the slot KV is made at the first admission: legacy static-batch
        # users do not pay for it
        self._k = self._v = None
        self.prefill_chunks = 0   # chunks run since the engine was made

    def _alloc_kv(self) -> None:
        check_family(self.cfg)
        if self.ecfg.kv_quant:
            # the slot steps carry no k_scale/v_scale: an int8 cache there
            # would be unscaled truncation
            raise ValueError(
                "slot engine does not support int8 KV quantization; "
                "use the legacy prefill/decode API for kv_quant")
        if self.ecfg.paged:
            kv = cache_mod.init_paged_cache(self.cfg, self.total_pages,
                                            self.ecfg.page_size,
                                            device=self.device)
        else:
            kv = cache_mod.init_cache(self.cfg, self.ecfg.n_slots,
                                      self.ecfg.max_len,
                                      device=self.device)
        self._k, self._v = kv["k"], kv["v"]

    # ----------------------- slot bookkeeping ----------------------- #
    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def free_slots(self) -> int:
        return sum(1 for s in self.slots if s is None)

    def active_rids(self) -> List[int]:
        return [s.rid for s in self.slots if s is not None]

    def has_request(self, rid: int) -> bool:
        return rid in self._by_rid

    def free_pages(self) -> int:
        """Unallocated pages of the paged pool (the KV admission bound)."""
        if not self.ecfg.paged:
            raise RuntimeError("free_pages() requires EngineConfig.paged")
        return len(self._free)

    def transport_stats(self) -> Dict:
        """Launch accounting of the disaggregated transport plane (empty on
        the coupled plane, which has no transport)."""
        return self.transport.stats.as_dict() if self.transport else {}

    def kv_stats(self) -> Dict[str, int]:
        """Slot occupancy, the dense slab's bytes and, when paged, the
        page pool's occupancy and bytes."""
        out = {
            "n_slots": self.n_slots,
            "slots_in_use": self.n_slots - self.free_slots(),
            "dense_slab_bytes": cache_mod.dense_cache_bytes(
                self.cfg, self.n_slots, self.ecfg.max_len),
        }
        if self.ecfg.paged:
            ps = self.ecfg.page_size
            out.update(page_size=ps, n_pages=self.total_pages,
                       pages_in_use=self.total_pages - len(self._free),
                       peak_pages=self.peak_pages,
                       pool_bytes=cache_mod.paged_cache_bytes(
                           self.cfg, self.total_pages, ps))
        return out

    def _alloc_page(self) -> int:
        p = self._free.pop()
        self.peak_pages = max(self.peak_pages,
                              self.total_pages - len(self._free))
        return p

    # ---------------------- admission / eviction --------------------- #
    def add_request(self, rid: int, prompt: Sequence[int],
                    adapter_id: int) -> int:
        """Admit a request into a free slot: allocate the pages of its
        prompt (paged) and prime its KV by chunked prefill. Returns the
        slot."""
        if rid in self._by_rid:
            raise ValueError(f"rid {rid} already running")
        slot = next((i for i, s in enumerate(self.slots) if s is None), None)
        if slot is None:
            raise RuntimeError("no free decode slot")
        if self._k is None:
            self._alloc_kv()
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        plen = int(prompt.shape[0])
        if plen < 1 or plen > self.ecfg.max_len:
            raise ValueError(f"prompt length {plen} vs max_len "
                             f"{self.ecfg.max_len}")
        if self.ecfg.paged:
            need = cache_mod.pages_for(plen - 1, self.ecfg.page_size)
            if need > len(self._free):
                raise RuntimeError(
                    f"rid {rid}: free KV pages ({len(self._free)}) do not "
                    f"cover the prompt ({need} pages)")
            for j in range(need):
                self._bt[slot, j] = self._alloc_page()
        if plen > 1:
            self._prefill_slot(slot, prompt[:-1])
        self.slots[slot] = SlotState(rid=rid, adapter_id=int(adapter_id),
                                     pos=plen - 1, last_token=int(prompt[-1]))
        self._by_rid[rid] = slot
        return slot

    def _prefill_slot(self, slot: int, toks: np.ndarray) -> None:
        """Chunked prefill of ``toks`` into the slot's pages or rows. The
        last chunk is zero-padded; its padded positions lie past the slot's
        position, so every attention masks them until decode overwrites
        them."""
        n_tok = int(toks.shape[0])
        C, ps = self._chunk, self.ecfg.page_size
        L, _, _, KV, hd = self._k.shape
        dev = self.device
        for c in range(0, n_tok, C):
            w = min(C, self.ecfg.max_len - c)
            chunk = np.zeros((1, w), np.int64)
            m = min(w, n_tok - c)
            chunk[0, :m] = toks[c:c + m]
            if self.ecfg.paged:
                ctx = torch.as_tensor(self._bt[slot, : c // ps],
                                      dtype=torch.long, device=dev)
                k_ctx = self._k[:, ctx].reshape(L, 1, -1, KV, hd)
                v_ctx = self._v[:, ctx].reshape(L, 1, -1, KV, hd)
            else:
                k_ctx = self._k[:, slot:slot + 1, :c]
                v_ctx = self._v[:, slot:slot + 1, :c]
            self.prefill_chunks += 1
            k_c, v_c = transformer.prefill_chunk(
                self.params, self.cfg, torch.as_tensor(chunk, device=dev),
                k_ctx, v_ctx)
            if not self.ecfg.paged:
                self._k[:, slot, c:c + w] = k_c[:, 0].to(self._k.dtype)
                self._v[:, slot, c:c + w] = v_c[:, 0].to(self._v.dtype)
                continue
            # the chunk's pages; unallocated ones (a padded tail) are skipped
            have = self._bt[slot, c // ps: c // ps + w // ps]
            keep = np.nonzero(have >= 0)[0]
            pages = torch.as_tensor(have[keep], dtype=torch.long, device=dev)
            sel = torch.as_tensor(keep, dtype=torch.long, device=dev)
            for pool, rows in ((self._k, k_c), (self._v, v_c)):
                pool[:, pages] = rows.reshape(L, w // ps, ps, KV, hd)[:, sel] \
                    .to(pool.dtype)

    def evict_request(self, rid: int) -> None:
        """Free a slot at a step boundary. Paged: its pages return to the
        pool. Dense: its rows stay; a later occupant masks them by its own
        position."""
        slot = self._by_rid.pop(rid)
        self.slots[slot] = None
        if self.ecfg.paged:
            self._free.extend(int(p) for p in self._bt[slot] if p >= 0)
            self._bt[slot, :] = -1

    def release_kv(self) -> None:
        """Drop the KV pool or slab of an empty engine (its memory comes
        back); the next admission allocates it again."""
        if self._by_rid:
            raise RuntimeError(
                f"release_kv with {len(self._by_rid)} requests resident")
        if self.transport is not None and self._k is not None:
            self.transport.forget_kv(self._k, self._v)
        self._k = self._v = None
        if self.ecfg.paged:
            self._bt[:] = -1
            self._free = list(range(self.total_pages - 1, -1, -1))

    # ---------------------------- decode ----------------------------- #
    def step(self) -> Dict[int, int]:
        """Decode one token for every occupied slot; returns {rid: token}.
        Paged: each row's next page is allocated on demand and the step
        reads and writes the shared pool. Dense: the occupied slots' rows
        are gathered into the bucket (padding rows repeat slot 0 and write
        nothing) and the occupied ones scattered back."""
        occupied = [i for i, s in enumerate(self.slots) if s is not None]
        if not occupied:
            return {}
        nb = _bucket(len(occupied), self.n_slots)
        sel = np.zeros(nb, np.int64)
        sel[: len(occupied)] = occupied
        # padding rows scatter past the slab: dropped
        scatter_idx = np.full(nb, self.n_slots, np.int64)
        scatter_idx[: len(occupied)] = occupied
        toks = np.zeros((nb, 1), np.int64)
        pos_vec = np.full(nb, -1, np.int32)
        ads = np.full(nb, -1, np.int32)
        for row, i in enumerate(occupied):
            s = self.slots[i]
            if s.pos >= self.ecfg.max_len:
                raise RuntimeError(
                    f"rid {s.rid} exhausted slot KV capacity "
                    f"(pos {s.pos} >= max_len {self.ecfg.max_len})")
            if self.ecfg.paged:
                pidx = s.pos // self.ecfg.page_size
                if self._bt[i, pidx] < 0:
                    if not self._free:
                        raise RuntimeError(
                            f"rid {s.rid}: KV page pool exhausted mid-decode")
                    self._bt[i, pidx] = self._alloc_page()
            toks[row, 0] = s.last_token
            pos_vec[row] = s.pos
            ads[row] = s.adapter_id
        paged = self.ecfg.paged
        bt = self._bt[sel] if paged else None
        if self.transport is not None:
            tok, _, _ = self.transport.decode_step(
                self.params, self.cfg, self._k, self._v, toks, pos_vec, ads,
                self.lora_scale, sel=None if paged else sel,
                scatter_idx=None if paged else scatter_idx, block_table=bt)
        else:
            tok = self._coupled_step(toks, pos_vec, ads, sel, bt,
                                     len(occupied))
        out: Dict[int, int] = {}
        for row, i in enumerate(occupied):
            s = self.slots[i]
            s.pos += 1
            s.last_token = int(tok[row])
            out[s.rid] = s.last_token
        return out

    def _coupled_step(self, toks, pos_vec, ads, sel, bt, n_occ: int):
        dev = self.device
        toks_t = torch.as_tensor(toks, device=dev)
        pos_t = torch.as_tensor(pos_vec, device=dev)
        ads_t = torch.as_tensor(ads, device=dev)
        if self.ecfg.paged:
            k, v = self._k, self._v
            bt = torch.as_tensor(bt, device=dev)
        else:
            sel_t = torch.as_tensor(sel, device=dev)
            k, v = self._k[:, sel_t], self._v[:, sel_t]
        lora_ctx = (self.pool.lora_ctx(ads_t) if self.pool is not None
                    else None)
        logits, k, v = transformer.decode_step_slots(
            self.params, self.cfg, k, v, toks_t, pos_t, lora_ctx,
            block_table=bt)
        if not self.ecfg.paged:
            # padding rows sit past the occupied ones: they are not written
            occ = sel_t[:n_occ]
            self._k[:, occ] = k[:, :n_occ]
            self._v[:, occ] = v[:, :n_occ]
        return torch.argmax(logits[:, : self.cfg.vocab_size], dim=-1).tolist()

    # ------------------ legacy static-batch API ------------------------ #
    def prefill(self, tokens, frontend_emb=None) -> Dict:
        """tokens: (B, S_prompt) -> a ``cache.init_cache`` cache primed with
        the prompt (``max_len`` positions, int8 with ``kv_quant``).

        Dense, moe and vlm prompts without a frontend run as ONE parallel
        LoRA-free ``forward(collect_kv=True, unembed=False)``, their KV
        written (or quantized) into the cache. The ssm, hybrid and audio
        families, and any prompt with ``frontend_emb``, replay the prompt
        token by token through ``decode_step``, as the reference does: a
        vlm's frontend is then dropped, and an audio model's cross cache
        stays empty (the caller fills ck/cv/cross_len from
        ``forward(..., frontend_emb, collect_kv=True)``)."""
        dev = self.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        B, S = tokens.shape
        cache = cache_mod.init_cache(self.cfg, B, self.ecfg.max_len,
                                     self.ecfg.kv_quant, device=dev)
        if self.cfg.family in SLOT_FAMILIES and S > 0 \
                and frontend_emb is None:
            if S > self.ecfg.max_len:
                raise ValueError(f"prompt length {S} vs max_len "
                                 f"{self.ecfg.max_len}")
            _, (k_rows, v_rows) = transformer.forward(
                self.params, self.cfg, tokens, collect_kv=True,
                unembed=False)
            if self.ecfg.kv_quant:
                for name, rows in (("k", k_rows), ("v", v_rows)):
                    q, scale = cache_mod.quantize_kv(rows)
                    cache[name][:, :, :S] = q
                    cache[name + "_scale"][:, :, :S] = scale
            else:
                cache["k"][:, :, :S] = k_rows.to(cache["k"].dtype)
                cache["v"][:, :, :S] = v_rows.to(cache["v"].dtype)
            cache["pos"] = S
            return cache
        for t in range(S):
            _, cache = transformer.decode_step(self.params, self.cfg, cache,
                                               tokens[:, t:t + 1])
        return cache

    def decode(self, cache: Dict, last_token, steps: int,
               adapter_ids=None) -> torch.Tensor:
        """Greedy-decode ``steps`` tokens from a ``prefill`` cache (its KV
        written in place). last_token: (B, 1); adapter_ids: (B,) global
        adapter ids, one a row (-1 = none). With a server and ids each step
        is ``disagg.disagg_decode_step`` (a ``ServerPool`` routed from the
        host-side ids before each step), else ``transformer.decode_step``
        with the pool's adapters (coupled; None without ids). Returns the
        tokens (B, steps) int32 on the device, no host sync a step.

        A disaggregated decode over an int8 cache is refused: the
        reference's runs it without the scales and gets garbage."""
        dev = self.device
        tok = torch.as_tensor(last_token, device=dev).long()
        tok = tok.reshape(tok.shape[0], 1)
        disagg_plane = self.server is not None and adapter_ids is not None
        if disagg_plane and "k_scale" in cache:
            raise ValueError(
                "disaggregated decode does not support int8 KV "
                "quantization: serve kv_quant on the coupled plane")
        ids = ids_host = lora_ctx = None
        if adapter_ids is not None:
            ids_host = np.asarray(adapter_ids.cpu() if torch.is_tensor(
                adapter_ids) else adapter_ids, np.int32).reshape(-1)
            ids = torch.as_tensor(ids_host, device=dev)
            if self.pool is not None and self.server is None:
                lora_ctx = self.pool.lora_ctx(ids)
        route = getattr(self.server, "route_step", None) \
            if disagg_plane else None
        out = []
        for _ in range(steps):
            if disagg_plane:
                if route is not None:
                    route(ids_host)
                try:
                    logits, cache = disagg.disagg_decode_step(
                        self.params, self.cfg, cache, tok, self.server, ids,
                        self.lora_scale)
                finally:
                    if route is not None:
                        route(None)
            else:
                logits, cache = transformer.decode_step(
                    self.params, self.cfg, cache, tok, lora_ctx)
            logits = logits[:, : self.cfg.vocab_size]
            tok = torch.argmax(logits, dim=-1)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1).to(torch.int32)
