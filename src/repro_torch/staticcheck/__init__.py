"""repro_torch.staticcheck — AST-based static guards for the port's
runtime invariants, the counterpart of ``repro.staticcheck``.

The port's correctness rests on contracts its runtime tests pin on the
paths they drive: the mesh serving plane's tokens bit for bit those of one
device, one CUDA graph a fused decode step with nothing on the host inside
it, every hand-written kernel beside a plain twin and a parity test, no
read of a buffer an in-place update has retired. This package is their
lint-time twin: the reference's stdlib-``ast`` engine (no torch and no jax
import), with the seven rules recast for the port's hazards.

Rules (each docstring names the invariant and the test that pins it):

  SC001 no-collectives-in-serving-plane   SC005 retired-alias-read
  SC002 host-sync-in-capture              SC006 host-transfer-in-capture
  SC003 recapture-hazard                  SC007 raw-timing-instrumentation
  SC004 kernel-twin-discipline

Usage::

    python -m repro_torch.staticcheck src/repro_torch chip_smoke.py

Inline suppression (same line or the standalone comment line above), with
its reason::

    x = int(n.sum())  # staticcheck: disable=SC002 (eager path only)

A baseline file (``staticcheck.baseline.json``, auto-loaded from the
working directory, or ``--baseline``) grandfathers findings; the shipped
tree needs none.
"""
from repro_torch.staticcheck.engine import (  # noqa: F401
    Finding,
    ModuleInfo,
    ProjectContext,
    Report,
    load_baseline,
    run_paths,
    write_baseline,
)
from repro_torch.staticcheck.rules import ALL_RULES, get_rules  # noqa: F401

__all__ = [
    "ALL_RULES",
    "Finding",
    "ModuleInfo",
    "ProjectContext",
    "Report",
    "get_rules",
    "load_baseline",
    "run_paths",
    "write_baseline",
]
