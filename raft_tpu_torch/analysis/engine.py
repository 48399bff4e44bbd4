"""The analyzer's engine — the port of ``raft_tpu/analysis/engine.py``:
file walking, rule dispatch, suppressions, baseline, CLI.

The pipeline per file is two passes: parse + fact gathering
(:class:`~raft_tpu_torch.analysis.facts.ModuleFacts`), then every rule runs
over the facts and emits :class:`Finding`\\ s. Findings are filtered
through

* **per-line suppressions** — ``# jaxlint: disable=rule-a,rule-b`` on the
  flagged physical line (the JAX package's marker, so one source runs
  through both analyzers unchanged);
* **the baseline** — a checked-in JSON file of grandfathered finding keys
  (``path::rule::message`` → count), so a new rule can land as a hard
  gate while its existing debt is burned down incrementally. The port's
  is ``raft_tpu_torch/analysis/lint_baseline.json``, and it is empty.

Exit status is 0 iff no *new* findings survive both filters.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import re
import sys
from pathlib import Path
from typing import TYPE_CHECKING, Dict, Iterable, Iterator, List, Optional

from raft_tpu_torch.analysis.facts import ModuleFacts

if TYPE_CHECKING:
    from raft_tpu_torch.analysis.rules import Rule

DEFAULT_BASELINE = Path(__file__).resolve().parent / "lint_baseline.json"

_SUPPRESS_RE = re.compile(r"#\s*jaxlint:\s*disable=([A-Za-z0-9_,\- ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: where, which rule, and what."""

    path: str      # repo-relative posix path
    line: int
    col: int
    rule: str
    message: str

    @property
    def baseline_key(self) -> str:
        # line numbers are deliberately absent: unrelated edits above a
        # grandfathered finding must not invalidate the baseline
        return f"{self.path}::{self.rule}::{self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


class FileContext:
    """Everything a rule sees for one file."""

    def __init__(self, path: Path, rel: str, text: str, tree: ast.Module):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = tree
        self.facts = ModuleFacts(tree)

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(
            path=self.rel,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            rule=rule,
            message=message,
        )

    def suppressed_rules(self, line: int) -> frozenset:
        """Rules disabled on a given 1-based physical line."""
        if not (1 <= line <= len(self.lines)):
            return frozenset()
        m = _SUPPRESS_RE.search(self.lines[line - 1])
        if not m:
            return frozenset()
        return frozenset(p.strip() for p in m.group(1).split(",") if p.strip())


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]
    suppressed: int
    baselined: int
    checked_files: int
    parse_errors: List[Finding]

    @property
    def clean(self) -> bool:
        return not self.findings and not self.parse_errors


def iter_py_files(paths: Iterable[Path]) -> Iterator[Path]:
    for p in paths:
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" not in f.parts:
                    yield f
        elif p.suffix == ".py":
            yield p


def _relpath(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


class Baseline:
    """Grandfathered findings: baseline_key -> allowed count."""

    def __init__(self, counts: Optional[Dict[str, int]] = None):
        self.counts: Dict[str, int] = dict(counts or {})

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        data = json.loads(path.read_text())
        return cls(data.get("findings", {}))

    def save(self, path: Path, findings: Iterable[Finding]) -> None:
        counts: Dict[str, int] = {}
        for f in findings:
            counts[f.baseline_key] = counts.get(f.baseline_key, 0) + 1
        payload = {
            "comment": "grandfathered lint findings of the port — burn down, never add",
            "version": 1,
            "findings": dict(sorted(counts.items())),
        }
        path.write_text(json.dumps(payload, indent=2) + "\n")

    def filter(self, findings: List[Finding]):
        """Split into (new, grandfathered), honoring per-key counts."""
        budget = dict(self.counts)
        new: List[Finding] = []
        old: List[Finding] = []
        for f in findings:
            k = f.baseline_key
            if budget.get(k, 0) > 0:
                budget[k] -= 1
                old.append(f)
            else:
                new.append(f)
        return new, old


def lint_file(path: Path, root: Path, rules: List["Rule"]):
    """Returns (kept_findings, n_suppressed, parse_error_or_None)."""
    rel = _relpath(path, root)
    text = path.read_text()
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        err = Finding(rel, e.lineno or 1, (e.offset or 0) + 1, "parse",
                      f"syntax error: {e.msg}")
        return [], 0, err
    ctx = FileContext(path, rel, text, tree)
    kept: List[Finding] = []
    suppressed = 0
    for rule in rules:
        for f in rule.check(ctx):
            if rule.name in ctx.suppressed_rules(f.line):
                suppressed += 1
            else:
                kept.append(f)
    kept.sort(key=lambda f: (f.line, f.col, f.rule))
    return kept, suppressed, None


def lint_paths(
    paths: Iterable[Path],
    root: Optional[Path] = None,
    rules: Optional[List["Rule"]] = None,
    baseline: Optional[Baseline] = None,
) -> LintResult:
    from raft_tpu_torch.analysis.rules import ALL_RULES

    root = root or Path.cwd()
    rules = ALL_RULES if rules is None else rules
    findings: List[Finding] = []
    parse_errors: List[Finding] = []
    suppressed = 0
    n_files = 0
    for f in iter_py_files(paths):
        n_files += 1
        kept, n_sup, err = lint_file(f, root, rules)
        findings.extend(kept)
        suppressed += n_sup
        if err is not None:
            parse_errors.append(err)
    baselined: List[Finding] = []
    if baseline is not None:
        findings, baselined = baseline.filter(findings)
    return LintResult(
        findings=findings,
        suppressed=suppressed,
        baselined=len(baselined),
        checked_files=n_files,
        parse_errors=parse_errors,
    )


def lint_source(source: str, rules: Optional[List["Rule"]] = None,
                rel: str = "<string>") -> List[Finding]:
    """Lint a source snippet in memory — the test-fixture entry point."""
    from raft_tpu_torch.analysis.rules import ALL_RULES

    tree = ast.parse(source)
    ctx = FileContext(Path(rel), rel, source, tree)
    kept: List[Finding] = []
    for rule in (ALL_RULES if rules is None else rules):
        for f in rule.check(ctx):
            if rule.name not in ctx.suppressed_rules(f.line):
                kept.append(f)
    kept.sort(key=lambda f: (f.line, f.col, f.rule))
    return kept


def main(argv: Optional[List[str]] = None) -> int:
    from raft_tpu_torch.analysis.rules import ALL_RULES

    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.analysis",
        description="static analysis of raft_tpu_torch: serving-path "
                    "lint rules and the concurrency auditor",
    )
    ap.add_argument("paths", nargs="*", default=["."],
                    help="files or directories to lint (default: .)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", type=Path, default=None,
                    help=f"baseline JSON (default: {DEFAULT_BASELINE} "
                         "if it exists)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline and exit 0")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset to run")
    ap.add_argument("--list-rules", action="store_true")
    # -- the thread tier (the concurrency auditor): the census and graph
    # code only loads when asked for
    ap.add_argument("--threads", action="store_true",
                    help="run the concurrency auditor (thread rules + "
                         "lock-order graph against "
                         "raft_tpu_torch/analysis/lock_order.json) "
                         "instead of the lint rules")
    ap.add_argument("--lock-order", type=Path, default=None,
                    help="lock-order JSON (default: "
                         "raft_tpu_torch/analysis/lock_order.json)")
    ap.add_argument("--write-lock-order", action="store_true",
                    help="re-bless the observed lock-order edges and "
                         "grandfather current thread findings (cycles "
                         "still fail)")
    args = ap.parse_args(argv)

    if args.threads:
        from raft_tpu_torch.analysis.threads.lock_order import main_threads

        return main_threads(args)
    if args.write_lock_order:
        print("analysis: --write-lock-order requires --threads",
              file=sys.stderr)
        return 2

    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.name}: {r.description}")
        return 0

    rules = ALL_RULES
    if args.rules:
        wanted = {s.strip() for s in args.rules.split(",")}
        unknown = wanted - {r.name for r in ALL_RULES}
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = [r for r in ALL_RULES if r.name in wanted]

    if args.write_baseline and args.rules:
        print("analysis: --write-baseline with --rules would rewrite the "
              "baseline from a rule subset, dropping every other rule's "
              "grandfathered findings; run --write-baseline with the "
              "full rule set", file=sys.stderr)
        return 2

    baseline_path = args.baseline or DEFAULT_BASELINE
    baseline: Optional[Baseline] = None
    if not args.no_baseline and not args.write_baseline \
            and baseline_path.exists():
        baseline = Baseline.load(baseline_path)

    paths = [Path(p) for p in args.paths]
    result = lint_paths(paths, rules=rules, baseline=baseline)

    if args.write_baseline:
        Baseline().save(baseline_path, result.findings)
        print(f"analysis: wrote {len(result.findings)} finding(s) to "
              f"{baseline_path}")
        return 0

    all_out = result.parse_errors + result.findings
    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in all_out],
            "suppressed": result.suppressed,
            "baselined": result.baselined,
            "checked_files": result.checked_files,
            "rules": [r.name for r in rules],
        }, indent=2))
    else:
        for f in all_out:
            print(f.render())
        print(
            f"analysis: checked {result.checked_files} files — "
            f"{len(all_out)} finding(s), {result.suppressed} suppressed, "
            f"{result.baselined} baselined"
        )
    return 0 if result.clean else 1
