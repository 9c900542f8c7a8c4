"""Rule engine: file walking, suppression parsing, baselines, reporting
(a copy of ``repro.staticcheck.engine``).

Pipeline: collect ``*.py`` files -> parse every module ONCE (rules share
the trees) -> give each rule a project-wide ``prepare`` pass (cross-module
facts) -> run each rule per module -> drop inline-suppressed findings ->
subtract the baseline -> report. Everything is stdlib: it runs without
torch or jax installed.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.staticcheck.astutil import ModuleIndex

# ``# staticcheck: disable=SC001`` / ``disable=SC001,SC005 (reason)`` —
# effective for findings on the same line, or on the next line when the
# directive is a standalone comment line (the long-call-spans-lines case).
_SUPPRESS = re.compile(r"#\s*staticcheck:\s*disable=([A-Z0-9,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str          # "SC001"
    path: str          # repo-relative posix path
    line: int          # 1-based
    col: int           # 0-based
    message: str

    def fingerprint(self) -> Tuple[str, str, str]:
        """Line numbers shift on every edit; identity for baselining is
        (rule, file, message)."""
        return (self.rule, self.path, self.message)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}"


class ModuleInfo:
    """One parsed source file + its suppression map."""

    def __init__(self, path: pathlib.Path, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(source)
        except SyntaxError as e:  # surfaced as an SC000 finding
            self.parse_error = e
        self._index: Optional[ModuleIndex] = None
        self.suppressions: Dict[int, set] = {}
        for lineno, text in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS.search(text)
            if not m:
                continue
            ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
            self.suppressions.setdefault(lineno, set()).update(ids)
            if text.lstrip().startswith("#"):
                # standalone directive line also covers the next line
                self.suppressions.setdefault(lineno + 1, set()).update(ids)

    @property
    def index(self) -> ModuleIndex:
        if self._index is None:
            assert self.tree is not None
            self._index = ModuleIndex(self.tree)
        return self._index

    def suppressed(self, finding: Finding) -> bool:
        ids = self.suppressions.get(finding.line, set())
        return finding.rule in ids or "ALL" in ids


class ProjectContext:
    """Cross-module facts the rules share.

    ``donating`` is the reference's donating-jit registry (unused by the
    port's rules). ``root`` anchors sibling lookups (kernels/ref.py twins,
    csrc/*.cu, tests/test_torch_*.py)."""

    def __init__(self, root: pathlib.Path):
        self.root = root
        self.donating: Dict[str, Tuple[int, ...]] = {}
        self.modules: List[ModuleInfo] = []

    def module_by_relpath(self, suffix: str) -> Optional[ModuleInfo]:
        for mod in self.modules:
            if mod.relpath.endswith(suffix):
                return mod
        return None


@dataclasses.dataclass
class Report:
    findings: List[Finding]          # new (unsuppressed, unbaselined)
    baselined: List[Finding]
    suppressed_count: int
    checked_files: int

    @property
    def ok(self) -> bool:
        return not self.findings

    def as_dict(self) -> Dict:
        return {
            "version": 1,
            "checked_files": self.checked_files,
            "new_findings": [f.as_dict() for f in self.findings],
            "baselined_findings": [f.as_dict() for f in self.baselined],
            "suppressed": self.suppressed_count,
            "ok": self.ok,
        }


def _iter_py_files(paths: Sequence[str]) -> List[pathlib.Path]:
    out: List[pathlib.Path] = []
    for p in paths:
        path = pathlib.Path(p)
        if path.is_dir():
            out.extend(sorted(
                f for f in path.rglob("*.py")
                if "__pycache__" not in f.parts
                and not any(part.startswith(".") for part in f.parts)))
        elif path.suffix == ".py":
            out.append(path)
    # de-dupe while keeping order (overlapping path args)
    seen, files = set(), []
    for f in out:
        key = f.resolve()
        if key not in seen:
            seen.add(key)
            files.append(f)
    return files


def _relpath(path: pathlib.Path, root: pathlib.Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def load_modules(paths: Sequence[str],
                 root: Optional[pathlib.Path] = None) -> ProjectContext:
    root = root or pathlib.Path.cwd()
    ctx = ProjectContext(root)
    for f in _iter_py_files(paths):
        ctx.modules.append(ModuleInfo(f, _relpath(f, root), f.read_text()))
    return ctx


def run_modules(ctx: ProjectContext, rules=None) -> List[Finding]:
    """All raw findings (suppressions applied, baseline NOT applied)."""
    from repro_torch.staticcheck.rules import get_rules
    rules = get_rules() if rules is None else rules
    findings: List[Finding] = []
    for mod in ctx.modules:
        if mod.parse_error is not None:
            e = mod.parse_error
            findings.append(Finding(
                "SC000", mod.relpath, e.lineno or 1, e.offset or 0,
                f"syntax error: {e.msg}"))
    for rule in rules:
        prepare = getattr(rule, "prepare", None)
        if prepare is not None:
            prepare(ctx)
    for rule in rules:
        for mod in ctx.modules:
            if mod.tree is None:
                continue
            findings.extend(rule.check_module(mod, ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def split_suppressed(ctx: ProjectContext, findings: Iterable[Finding]
                     ) -> Tuple[List[Finding], int]:
    by_rel = {m.relpath: m for m in ctx.modules}
    kept: List[Finding] = []
    n_suppressed = 0
    for f in findings:
        mod = by_rel.get(f.path)
        if mod is not None and mod.suppressed(f):
            n_suppressed += 1
        else:
            kept.append(f)
    return kept, n_suppressed


# ----------------------------- baseline ------------------------------- #
def load_baseline(path: pathlib.Path) -> Dict[Tuple[str, str, str], int]:
    data = json.loads(path.read_text())
    out: Dict[Tuple[str, str, str], int] = {}
    for entry in data.get("findings", []):
        key = (entry["rule"], entry["path"], entry["message"])
        out[key] = out.get(key, 0) + int(entry.get("count", 1))
    return out


def write_baseline(path: pathlib.Path, findings: Iterable[Finding]) -> None:
    counts: Dict[Tuple[str, str, str], int] = {}
    for f in findings:
        counts[f.fingerprint()] = counts.get(f.fingerprint(), 0) + 1
    entries = [{"rule": r, "path": p, "message": m, "count": n}
               for (r, p, m), n in sorted(counts.items())]
    path.write_text(json.dumps({"version": 1, "findings": entries},
                               indent=2) + "\n")


def apply_baseline(findings: List[Finding],
                   baseline: Dict[Tuple[str, str, str], int]
                   ) -> Tuple[List[Finding], List[Finding]]:
    """Split into (new, baselined): the first ``count`` occurrences of a
    baselined fingerprint are grandfathered, any excess is new."""
    budget = dict(baseline)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        key = f.fingerprint()
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old


def run_paths(paths: Sequence[str], *, root: Optional[pathlib.Path] = None,
              baseline: Optional[pathlib.Path] = None,
              rules=None) -> Report:
    """The one-call API the tests and the CLI share."""
    ctx = load_modules(paths, root=root)
    raw = run_modules(ctx, rules=rules)
    kept, n_suppressed = split_suppressed(ctx, raw)
    base = load_baseline(baseline) if baseline and baseline.exists() else {}
    new, old = apply_baseline(kept, base)
    return Report(findings=new, baselined=old,
                  suppressed_count=n_suppressed,
                  checked_files=len(ctx.modules))
