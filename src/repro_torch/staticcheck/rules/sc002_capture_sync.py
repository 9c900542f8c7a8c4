"""SC002 host-sync-in-capture.

Invariant guarded: the fused transport runs a decode step as one CUDA
graph replay, with no host work inside it (``tests/test_torch_transport.py``
and ``chip_smoke.py`` phase 6: fused == host tokens bit for bit, one
dispatch and no hook call a fused step, each capture one step's kernels).
A host sync in code a capture runs either fails the capture (C6: three
``.item()`` a layer in the paged KV write failed the first graph capture)
or, in the warm-up that precedes it, bakes one step's value into every
replay.

Flagged in code reachable from a capture (``_capture.captured``):
``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
``torch.cuda.synchronize()``, ``np.asarray`` / ``np.array``, and
``int()`` / ``float()`` / ``bool()`` of a reduction method's result
(``int(x.sum())``, ``bool(m.any())``; a receiver ``np`` / ``math`` is
host arithmetic and not flagged).

Heuristic bounds: the reachability follows bare names and the port's own
imports, not calls on objects (``EXTRA_ROOTS`` names those bodies); an
``int(t)`` of a tensor held in a plain name escapes it, as does a sync
behind a helper of another package.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.staticcheck.astutil import call_name, name_tail
from repro_torch.staticcheck.engine import Finding, ModuleInfo, \
    ProjectContext
from repro_torch.staticcheck.rules._capture import calls_in, captured

SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
SYNC_CALLS = frozenset({"torch.cuda.synchronize", "np.asarray", "np.array",
                        "numpy.asarray", "numpy.array"})
_CASTS = frozenset({"int", "float", "bool"})
_REDUCTIONS = frozenset({"sum", "max", "min", "any", "all", "mean",
                         "argmax", "argmin", "prod", "norm", "count_nonzero"})
_HOST_RECEIVERS = frozenset({"np", "numpy", "math"})


def host_sync(call: ast.Call):
    """What makes ``call`` a host sync, or None."""
    name = call_name(call) or ""
    if name in SYNC_CALLS:
        return name
    if isinstance(call.func, ast.Attribute) and \
            call.func.attr in SYNC_METHODS and not call.args:
        return "." + call.func.attr + "()"
    if isinstance(call.func, ast.Name) and call.func.id in _CASTS and \
            len(call.args) == 1:
        arg = call.args[0]
        if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute) \
                and arg.func.attr in _REDUCTIONS:
            recv = arg.func.value
            if not (isinstance(recv, ast.Name)
                    and recv.id in _HOST_RECEIVERS):
                return f"{call.func.id}(... .{name_tail(call_name(arg)) or arg.func.attr}())"
    return None


class HostSyncInCapture:
    rule_id = "SC002"
    name = "host-sync-in-capture"

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Finding]:
        bodies = captured(ctx).get(mod.relpath)
        if not bodies:
            return []
        findings = []
        for call in calls_in(bodies):
            what = host_sync(call)
            if what is None:
                continue
            findings.append(Finding(
                self.rule_id, mod.relpath, call.lineno, call.col_offset,
                f"host sync '{what}' in code a CUDA-graph capture runs: "
                f"the fused step must stay on the device (one replay a "
                f"step; C6 was three .item() a layer)"))
        return findings
