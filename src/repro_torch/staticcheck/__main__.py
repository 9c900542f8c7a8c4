"""CLI: ``python -m repro_torch.staticcheck [paths...] [--json] [--baseline F]``
(a copy of ``repro.staticcheck.__main__``).

Exit codes: 0 clean (every finding fixed, suppressed, or baselined),
1 new findings, 2 usage error. ``staticcheck.baseline.json`` in the
working directory is auto-loaded when ``--baseline`` is not given, so the
acceptance invocation stays ``python -m repro_torch.staticcheck
src/repro_torch chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.staticcheck.engine import (
    load_modules,
    run_modules,
    split_suppressed,
    load_baseline,
    apply_baseline,
    write_baseline,
    Report,
)
from repro_torch.staticcheck.rules import ALL_RULES, get_rules

DEFAULT_BASELINE = "staticcheck.baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.staticcheck",
        description="AST-based static guards for the port's runtime "
                    "invariants (SC001-SC007).")
    ap.add_argument("paths", nargs="*", default=["src"],
                    help="files/directories to check (default: src)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit a machine-readable report on stdout")
    ap.add_argument("--baseline", type=pathlib.Path, default=None,
                    help=f"baseline file of grandfathered findings "
                         f"(default: ./{DEFAULT_BASELINE} if present)")
    ap.add_argument("--write-baseline", type=pathlib.Path, default=None,
                    help="write the current findings as the new baseline "
                         "and exit 0")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids to run (e.g. "
                         "SC001,SC004)")
    ap.add_argument("--list-rules", action="store_true",
                    help="list registered rules and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for cls in ALL_RULES:
            print(f"{cls.rule_id}  {cls.name}")
        return 0

    select = None
    if args.select:
        select = {s.strip().upper() for s in args.select.split(",")
                  if s.strip()}
        known = {cls.rule_id for cls in ALL_RULES}
        unknown = select - known
        if unknown:
            print(f"unknown rule ids: {sorted(unknown)}", file=sys.stderr)
            return 2
    rules = get_rules(select)

    paths = args.paths or ["src"]
    missing = [p for p in paths if not pathlib.Path(p).exists()]
    if missing:
        print(f"no such path: {missing}", file=sys.stderr)
        return 2

    ctx = load_modules(paths)
    raw = run_modules(ctx, rules=rules)
    kept, n_suppressed = split_suppressed(ctx, raw)

    if args.write_baseline is not None:
        write_baseline(args.write_baseline, kept)
        print(f"wrote {len(kept)} finding(s) to {args.write_baseline}")
        return 0

    baseline_path = args.baseline
    if baseline_path is None:
        default = pathlib.Path(DEFAULT_BASELINE)
        baseline_path = default if default.exists() else None
    base = load_baseline(baseline_path) if baseline_path and \
        baseline_path.exists() else {}
    new, old = apply_baseline(kept, base)
    report = Report(findings=new, baselined=old,
                    suppressed_count=n_suppressed,
                    checked_files=len(ctx.modules))

    if args.as_json:
        print(json.dumps(report.as_dict(), indent=2))
    else:
        for f in report.findings:
            print(f.render())
        print(f"staticcheck: {len(ctx.modules)} files, "
              f"{len(report.findings)} new finding(s), "
              f"{len(report.baselined)} baselined, "
              f"{report.suppressed_count} suppressed")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
