"""Counts of the work one step issues, the counterpart of
``repro.analysis.hlo_parse`` (which reads compiled HLO; the port has none).

  with count() as c:
      step(...)
  c.summary()   # {"flops", "hbm_bytes", "coll_bytes", "coll_total"}

The summary has the keys ``hlo_parse.analyze_hlo`` returns, so
``analysis.roofline.analyze`` takes it as the reference takes parsed HLO.
What is counted, on this process (one rank):

  flops       : the aten contractions the step issues (mm, addmm, bmm,
                baddbmm, the SDPA kernels and convolutions: the formulas of
                ``torch.utils.flop_counter``), through a TorchDispatchMode,
                plus each hand-written kernel's operations
  hbm bytes   : operand + result bytes of every materialised aten op (views,
                allocations and metadata ops move nothing and are skipped;
                a gather counts 2x its result and its index, an in-place
                indexed write 2x its values and indices), plus each
                kernel's bytes; each collective 2x its result (a traffic
                proxy, the one ``hlo_parse`` states)
  collectives : result bytes of each all-gather, reduce-scatter, all-to-all
                and all-reduce ``distributed.collectives`` issues, by kind

The kernels are loaded through ``ctypes``, so no dispatch mode sees inside
them: ``kernels.ops`` reports each call at its routing point, the counter
adds ``roofline.kernel_work`` of it in both forms ("data" where the
operands hold data, and "shape") and counts none of the aten ops the call
makes inside (a twin's on the CPU or the meta device, the wrapper's own on
the card). So a step counted on the meta device and on a card read the
same work in the shape form.

The byte proxy is a proxy: it over-counts where the eager ops would be
fused (each intermediate is written and read back) and where an op reads a
slice of a larger operand it names whole; it under-counts an in-place
elementwise op's read of its destination. It is not tuned to meet any
bound.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis import roofline
from repro_torch.distributed import collectives
from repro_torch.kernels import ops

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")

_aten = torch.ops.aten
# ops that allocate or describe and move no bytes
_NO_TRAFFIC = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.detach, _aten.alias, _aten.lift_fresh,
    _aten._local_scalar_dense, _aten.sym_size, _aten.sym_stride,
    _aten.sym_numel, _aten.is_same_size, _aten.resolve_conj,
    _aten.resolve_neg, _aten.set_, _aten._unsafe_view,
}
# gathers: the rows they read, written once and read by the consumer (2x
# the result, the reference's rule for a materialisation) and the index
_GATHERS = {_aten.index, _aten.gather, _aten.index_select, _aten.embedding}
# in-place indexed writes: the values and indices they read, the slice of
# their destination they write; not the whole destination
_INDEXED_WRITES = {_aten.index_put_, _aten._index_put_impl_,
                   _aten.index_copy_, _aten.index_add_, _aten.scatter_,
                   _aten.scatter_add_, _aten.scatter_reduce_,
                   _aten.masked_scatter_}


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


class Counter(TorchDispatchMode):
    """The step's counts; see the module docstring. ``summary(form)``
    gives the totals with the kernels in ``form`` ("data", or "shape":
    the one a meta-device count has)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_bytes: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        # name -> {"calls", and per form "bytes" and "ops"}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.aten_ops = 0
        # aten op -> [flops, bytes, calls] (the breakdown ``summary`` tops)
        self.by_op: Dict[str, list] = {}
        self._inside = 0

    # --------------------------- aten ops ------------------------------ #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside or func.namespace != "aten":
            return out      # inside a kernel call, or a c10d collective
        packet = func._overloadpacket
        fl = nb = 0.0
        if packet in flop_registry:
            fa, fk = args, kwargs
            if "dtype" in func._overloadname:   # mm/bmm(..., out_dtype)
                fa = tuple(a for a in args if isinstance(a, torch.Tensor))
                fk = {k: v for k, v in kwargs.items() if k != "out_dtype"}
            fl = float(flop_registry[packet](*fa, **fk, out_val=out))
        if packet in _GATHERS:
            nb = float(2 * sum(_bytes(t) for t in tree_leaves(out)) + sum(
                _bytes(t) for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor) and not t.is_floating_point()))
        elif packet in _INDEXED_WRITES:
            nb = float(2 * sum(_bytes(t) for t in tree_leaves(
                (args[1:], kwargs))))
        elif not func.is_view and packet not in _NO_TRAFFIC:
            nb = float(sum(_bytes(t) for t in tree_leaves((args, kwargs)))
                       + sum(_bytes(t) for t in tree_leaves(out)))
        if fl or nb:
            self.aten_ops += 1
            self.flops += fl
            self.hbm_bytes += nb
            rec = self.by_op.setdefault(packet.__name__, [0.0, 0.0, 0])
            rec[0] += fl
            rec[1] += nb
            rec[2] += 1
        return out

    # ------------------ kernels (from kernels.ops) --------------------- #
    def enter_kernel(self, name: str, args, kw) -> None:
        if self._inside:
            self._inside += 1
            return
        self._inside += 1
        rec = self.kernels.setdefault(name, {"calls": 0})
        rec["calls"] += 1
        lead = next(a for a in args if isinstance(a, torch.Tensor))
        forms = roofline.FORMS if lead.device.type != "meta" else ("shape",)
        for form in forms:
            n_bytes, n_ops = roofline.kernel_work(name, args, kw, form)
            rec[f"{form}_bytes"] = rec.get(f"{form}_bytes", 0) + n_bytes
            rec[f"{form}_ops"] = rec.get(f"{form}_ops", 0) + n_ops

    def exit_kernel(self) -> None:
        self._inside -= 1

    # -------------- collectives (from distributed.collectives) ---------- #
    def collective(self, kind: str, result: torch.Tensor) -> None:
        if self._inside:
            return
        self.coll_bytes[kind] += _bytes(result)

    # ------------------------------ totals ------------------------------ #
    def summary(self, form: str = "shape") -> Dict:
        """{"flops", "hbm_bytes", "coll_bytes", "coll_total", "kernels",
        ...} with the kernels' work in ``form`` ("shape", or "data" where
        no call was on the meta device)."""
        if any(f"{form}_bytes" not in r for r in self.kernels.values()):
            raise ValueError(f"a kernel call on the meta device has no "
                             f"{form!r} work")
        k_bytes = sum(r[f"{form}_bytes"] for r in self.kernels.values())
        k_ops = sum(r[f"{form}_ops"] for r in self.kernels.values())
        coll = float(sum(self.coll_bytes.values()))
        return {"flops": self.flops + k_ops,
                "hbm_bytes": self.hbm_bytes + k_bytes + 2 * coll,
                "coll_bytes": dict(self.coll_bytes), "coll_total": coll,
                "form": form,
                "kernels": {n: {"calls": r["calls"],
                                "bytes": r[f"{form}_bytes"],
                                "ops": r[f"{form}_ops"]}
                            for n, r in sorted(self.kernels.items())},
                "aten_flops": self.flops, "aten_bytes": self.hbm_bytes,
                "aten_ops": self.aten_ops, "top_ops": self.top_ops()}

    def top_ops(self, n: int = 8) -> Dict[str, Dict]:
        """The ``n`` aten ops that moved the most bytes: {name: {"flops",
        "bytes", "calls"}}."""
        top = sorted(self.by_op.items(), key=lambda kv: -kv[1][1])[:n]
        return {k: {"flops": f, "bytes": b, "calls": c}
                for k, (f, b, c) in top}


@contextlib.contextmanager
def count():
    """A ``Counter`` over the block: aten ops through the dispatch mode,
    kernel calls from ``kernels.ops``, collectives from
    ``distributed.collectives``."""
    c = Counter()
    ops.COUNTERS.append(c)
    collectives.OBSERVERS.append(c)
    try:
        with c:
            yield c
    finally:
        ops.COUNTERS.remove(c)
        collectives.OBSERVERS.remove(c)
