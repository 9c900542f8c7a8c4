"""SC007 raw-timing-instrumentation (the reference's rule, kept).

Invariant guarded: all wall-clock instrumentation of the port flows
through its observability plane (``repro_torch.obs.clock.wall_time`` /
tracer span attributes), never through scattered ``time.time()`` /
``time.perf_counter()`` calls: one seam that a test can virtualise and
that ``chip_smoke.py``'s timings share. The JAX checker's own SC007
(``tests/test_staticcheck.py::test_shipped_tree_is_clean``) scans the
port's files with the same rule; this one pins it in
``tests/test_torch_staticcheck.py``.

Allowed locations: any path containing a ``benchmarks`` or ``obs``
directory component (benchmarks ARE the measurement harness; ``obs``
owns the seam). ``time.monotonic`` is deliberately not flagged — the
store's prefetch deadline arithmetic is scheduling, not telemetry.
Escape hatch: the standard inline suppression,
``# staticcheck: disable=SC007 (reason)``.

Heuristic bounds (documented, not accidental): the rule matches the
dotted forms ``time.time`` / ``time.perf_counter[_ns]`` and the bare
from-import forms ``perf_counter[_ns]``; a bare ``time()`` or an
``import time as t`` alias escapes it, which review catches.
"""
from __future__ import annotations

import pathlib
from typing import List

from repro_torch.staticcheck.astutil import call_name, iter_calls
from repro_torch.staticcheck.engine import Finding, ModuleInfo, ProjectContext

_FLAGGED_DOTTED = frozenset({
    "time.time", "time.perf_counter", "time.perf_counter_ns"})
_FLAGGED_BARE = frozenset({"perf_counter", "perf_counter_ns"})
_ALLOWED_PARTS = frozenset({"benchmarks", "obs"})


class RawTimingInstrumentation:
    rule_id = "SC007"
    name = "raw-timing-instrumentation"

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Finding]:
        if _ALLOWED_PARTS & set(pathlib.PurePosixPath(mod.relpath).parts):
            return []
        findings: List[Finding] = []
        for call in iter_calls(mod.tree):
            dotted = call_name(call) or ""
            if dotted in _FLAGGED_DOTTED or dotted in _FLAGGED_BARE:
                findings.append(Finding(
                    self.rule_id, mod.relpath, call.lineno,
                    call.col_offset,
                    f"raw wall-clock call '{dotted}': runtime timing "
                    "must flow through repro_torch.obs (wall_time() / tracer "
                    "spans) so the observability plane sees it — or "
                    "suppress with a reason if this is not "
                    "instrumentation"))
        return findings
