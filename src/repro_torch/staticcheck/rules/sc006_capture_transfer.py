"""SC006 host-transfer-in-capture (the reference's dispatch budget, on
the card).

Invariant guarded: one host dispatch a fused decode step
(``tests/test_torch_transport.py``: ``host_dispatches_per_step`` 1.0 and no
hook call a fused step; ``chip_smoke.py`` phases 6-7: a replay launches
nothing from the host). Its inputs reach the graph through one copy into
fixed-address buffers made before the capture (``_CapturedStep.load``).
A tensor built from host data inside code a capture runs
(``torch.tensor``, ``torch.as_tensor``, ``torch.from_numpy``, ``.cuda()``,
``.pin_memory()``) is copied once at the capture and then replayed
stale: every later step reads the first step's host values.

Flagged in code reachable from a capture (``_capture.captured``). Bounds
as SC002's. A transfer that runs only once, before any capture (a cached
constant), carries an inline suppression that says so.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.staticcheck.astutil import call_name
from repro_torch.staticcheck.engine import Finding, ModuleInfo, \
    ProjectContext
from repro_torch.staticcheck.rules._capture import calls_in, captured

TRANSFER_CALLS = frozenset({"torch.tensor", "torch.as_tensor",
                            "torch.from_numpy"})
TRANSFER_METHODS = frozenset({"cuda", "pin_memory"})


def host_transfer(call: ast.Call):
    name = call_name(call) or ""
    if name in TRANSFER_CALLS:
        return name
    if isinstance(call.func, ast.Attribute) and \
            call.func.attr in TRANSFER_METHODS:
        return "." + call.func.attr + "()"
    return None


class HostTransferInCapture:
    rule_id = "SC006"
    name = "host-transfer-in-capture"

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Finding]:
        bodies = captured(ctx).get(mod.relpath)
        if not bodies:
            return []
        findings = []
        for call in calls_in(bodies):
            what = host_transfer(call)
            if what is None:
                continue
            findings.append(Finding(
                self.rule_id, mod.relpath, call.lineno, call.col_offset,
                f"host-to-device tensor '{what}' in code a CUDA-graph "
                f"capture runs: a replay re-reads the captured copy, so "
                f"every step sees the first step's host values; load "
                f"inputs into the step's fixed buffers before the replay"))
        return findings
