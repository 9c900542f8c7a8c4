"""SC001 no-collectives-in-serving-plane.

Invariant guarded: the mesh serving plane's tokens are those of the run
without a mesh, bit for bit (``tests/test_torch_mesh.py``: serving under
(2, 1), (4, 1) and (2, 2) grids of the CPU == the run without a mesh; on
the cards ``chip_smoke.py`` phase 11). That holds because the plane is a
pure map: each block of experts runs its ``gmm`` on its own device
(``models/moe.py::expert_gmm``), rows and outputs move, and nothing is
reduced across positions. One ``torch.distributed`` collective (or one of
``distributed/collectives.py``'s) on that path turns the map into a
reduction whose float reassociation breaks the bit-identity.

Scope: every function of ``core/disagg.py`` and ``transport/``, and the
functions of ``models/moe.py`` reachable from ``expert_gmm``. The SPMD
steps communicate by design and are out of scope: ``distributed/``, and
``_moe_sharded`` and ``_sharded_attention`` (the sharded bodies of
``models/moe.py`` and ``models/layers.py``, which ``expert_gmm`` does not
reach).
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.staticcheck.astutil import call_name, iter_calls, \
    name_tail
from repro_torch.staticcheck.engine import Finding, ModuleInfo, \
    ProjectContext

COLLECTIVES = frozenset({
    # torch.distributed's
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_single", "reduce_scatter", "reduce_scatter_tensor",
    "reduce_scatter_single", "all_to_all", "all_to_all_single", "broadcast",
    "reduce", "send", "recv", "isend", "irecv", "barrier", "gather",
    "scatter", "all_gather_object", "broadcast_object_list",
    # distributed/collectives.py's
    "psum", "sum_grad", "all_gather_replicated",
})
_PREFIXES = ("dist", "torch.distributed", "col", "collectives")
WHOLE_MODULES = ("core/disagg.py",)
WHOLE_DIRS = ("transport",)
ROOTED = {"models/moe.py": ("expert_gmm",)}


def _in_scope(relpath: str):
    """None (out of scope), "all" or a tuple of root function names."""
    if any(relpath.endswith(s) for s in WHOLE_MODULES):
        return "all"
    parts = relpath.split("/")
    if any(d in parts[:-1] for d in WHOLE_DIRS):
        return "all"
    for suffix, roots in ROOTED.items():
        if relpath.endswith(suffix):
            return roots
    return None


def is_collective(call: ast.Call) -> bool:
    name = call_name(call) or ""
    tail = name_tail(name)
    if tail not in COLLECTIVES:
        return False
    head = name[: -len(tail) - 1] if "." in name else ""
    return head in _PREFIXES


class NoCollectivesInServingPlane:
    rule_id = "SC001"
    name = "no-collectives-in-serving-plane"

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Finding]:
        scope = _in_scope(mod.relpath)
        if scope is None:
            return []
        if scope == "all":
            bodies = [mod.tree]
        else:
            index = mod.index
            bodies = index.reachable([index.functions[n] for n in scope
                                      if n in index.functions])
        findings: List[Finding] = []
        seen = set()
        for body in bodies:
            for call in iter_calls(body):
                if id(call) in seen or not is_collective(call):
                    continue
                seen.add(id(call))
                findings.append(Finding(
                    self.rule_id, mod.relpath, call.lineno, call.col_offset,
                    f"collective '{call_name(call)}' on the mesh serving "
                    f"plane: its expert blocks are a pure map (tokens bit "
                    f"for bit the run without a mesh's); collectives "
                    f"belong to the SPMD steps (distributed/, "
                    f"_moe_sharded, _sharded_attention)"))
        return findings
