"""Cross-module lock-order graph + the ``--threads`` CLI entry point —
the port of ``raft_tpu/analysis/threads/lock_order.py``.

Builds the static **acquired-while-held** graph over every analyzed
file: an edge ``A -> B`` means some code path acquires lock ``B`` while
already holding lock ``A``. Edges come from four lexical shapes (all
resolved through the per-class census):

* nested ``with`` statements (``with self._lock: ... with
  self.hedge._lock:``);
* a call under a lock into an intra-class method that acquires an own
  lock;
* a call under a lock into a method of an attribute whose class is
  known (``self.admission.cancel_queued()`` under the executor lock
  -> ``AdmissionController._lock``), one level deep;
* metric traffic under a lock: ``.inc/.set/.add/.observe`` on a cached
  instrument handle -> the ``_Instrument._lock`` leaf, and registry
  factory calls (``reg.counter(...)``) -> ``MetricRegistry._lock``.

Graph nodes are ``ClassName.<attr>`` (constructing class, so the
``Counter``/``_Instrument`` subclass idiom maps to one node) or
``<module>.<var>`` for module-level locks.

The port's blessed partial order lives in
``raft_tpu_torch/analysis/lock_order.json`` (``"order"`` section),
written from the port's own source, with lint-baseline drift
discipline: an
observed edge not implied by the blessed order, or a blessed edge no
longer backed by an observed path, is a finding until re-blessed with
``--write-lock-order``. Cycles ALWAYS fail — including during
``--write-lock-order``; a cyclic order must never be pinned. The
``"findings"`` section grandfathers thread-rule findings exactly like
``lint_baseline.json`` does for the lint rules.

The runtime tracer (:mod:`raft_tpu_torch.analysis.threads.runtime`)
loads the same ``"order"`` section and asserts it under real
interleavings.
"""

from __future__ import annotations

import ast
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from raft_tpu_torch.analysis.engine import (
    Baseline,
    FileContext,
    Finding,
    iter_py_files,
    lint_paths,
    _relpath,
)
from raft_tpu_torch.analysis.threads.census import (
    INSTRUMENT_FACTORY_TAILS,
    ClassCensus,
    ModuleCensus,
    _self_attr,
    get_census,
)
from raft_tpu_torch.analysis.threads.rules import THREAD_RULES

__all__ = [
    "DEFAULT_LOCK_ORDER",
    "LockGraph",
    "build_graph",
    "main_threads",
]

DEFAULT_LOCK_ORDER = Path(__file__).resolve().parents[1] / "lock_order.json"

# method tails on a cached instrument handle that take the instrument's
# own lock (obs/metrics.py: every mutator is `with self._lock:`)
INSTRUMENT_METHOD_TAILS = frozenset({"inc", "set", "add", "observe"})
INSTRUMENT_NODE = "_Instrument._lock"
REGISTRY_NODE = "MetricRegistry._lock"


class LockGraph:
    """Directed acquired-while-held graph with edge provenance."""

    def __init__(self) -> None:
        self.edges: Dict[str, Set[str]] = {}
        # (src, dst) -> first "path:line" seen
        self.sites: Dict[Tuple[str, str], str] = {}

    def add(self, src: str, dst: str, site: str) -> None:
        if src == dst:
            return   # re-acquisition is the self-deadlock rule's turf
        self.edges.setdefault(src, set()).add(dst)
        self.sites.setdefault((src, dst), site)

    def edge_list(self) -> List[Tuple[str, str]]:
        return sorted((s, d) for s, dsts in self.edges.items()
                      for d in dsts)

    def to_order(self) -> Dict[str, List[str]]:
        return {s: sorted(d) for s, d in sorted(self.edges.items())}

    def cycles(self) -> List[List[str]]:
        """Every elementary cycle reachable by DFS (first-found per
        back edge — enough to name the offenders)."""
        out: List[List[str]] = []
        seen_cycles: Set[Tuple[str, ...]] = set()
        color: Dict[str, int] = {}   # 0/absent=white, 1=grey, 2=black
        stack: List[str] = []

        def visit(n: str) -> None:
            color[n] = 1
            stack.append(n)
            for m in sorted(self.edges.get(n, ())):
                c = color.get(m, 0)
                if c == 0:
                    visit(m)
                elif c == 1:
                    cyc = stack[stack.index(m):] + [m]
                    # canonicalize rotation so one cycle reports once
                    body = cyc[:-1]
                    i = body.index(min(body))
                    canon = tuple(body[i:] + body[:i])
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        out.append(list(canon) + [canon[0]])
            stack.pop()
            color[n] = 2

        for n in sorted(self.edges):
            if color.get(n, 0) == 0:
                visit(n)
        return out


def _has_path(order: Dict[str, List[str]], src: str, dst: str) -> bool:
    seen = {src}
    frontier = [src]
    while frontier:
        n = frontier.pop()
        for m in order.get(n, ()):
            if m == dst:
                return True
            if m not in seen:
                seen.add(m)
                frontier.append(m)
    return False


def _receiver_base(expr: ast.AST) -> Tuple[Optional[str], Optional[str]]:
    """Peel subscripts off a call receiver: ``self._m["q"].inc`` ->
    ``("attr", "_m")``; ``_M_FLIPS["down"].inc`` -> ``("name",
    "_M_FLIPS")``."""
    e = expr
    while isinstance(e, ast.Subscript):
        e = e.value
    attr = _self_attr(e)
    if attr is not None:
        return "attr", attr
    if isinstance(e, ast.Name):
        return "name", e.id
    return None, None


def _module_instruments(mc: ModuleCensus) -> Set[str]:
    """Module-level names whose assigned value contains a registry
    factory call (health.py's ``_M_FLIPS = {... reg.counter(...) ...}``
    idiom)."""
    out: Set[str] = set()
    for node in mc.tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for sub in ast.walk(node.value):
            if isinstance(sub, ast.Call):
                c = mc.facts.callee(sub)
                if c and c.rsplit(".", 1)[-1] in INSTRUMENT_FACTORY_TAILS:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            out.add(tgt.id)
                    break
    return out


def _own_acquired_nodes(census: ClassCensus) -> Dict[str, Set[str]]:
    """method -> graph node names of own locks it acquires."""
    out: Dict[str, Set[str]] = {}
    for method, _node, key in census.acquisitions:
        if key.startswith("self:"):
            name = census.module.lock_node_name(census, key)
            out.setdefault(method, set()).add(name)
    return out


def _census_edges(graph: LockGraph, mc: ModuleCensus, rel: str,
                  registry: Dict[str, ClassCensus]) -> None:
    mod_instruments = _module_instruments(mc)
    for census in list(mc.classes.values()) + [mc.toplevel]:
        own_acquired = _own_acquired_nodes(census)

        def node_name(key: str) -> str:
            return mc.lock_node_name(census, key)

        def site(node: ast.AST) -> str:
            return f"{rel}:{getattr(node, 'lineno', 1)}"

        # 1. nested with
        for _method, with_node, key in census.acquisitions:
            held = census.effective_held(with_node)
            if held:
                graph.add(node_name(held[-1]), node_name(key),
                          site(with_node))
        # 2-4. calls under a lock
        for node, _method in census.method_of.items():
            if not isinstance(node, ast.Call):
                continue
            held = census.effective_held(node)
            if not held:
                continue
            src = node_name(held[-1])
            f = node.func
            if not isinstance(f, ast.Attribute):
                # registry factory through a bare alias is handled below
                continue
            tail = f.attr
            kind, base = _receiver_base(f.value)
            # intra-class helper that acquires an own lock
            callee_attr = _self_attr(f)
            if callee_attr is not None and callee_attr in census.methods:
                for dst in own_acquired.get(callee_attr, ()):
                    # only an edge if the callee acquires a DIFFERENT
                    # lock than what is already held (nested-with case
                    # 1 covers the body; this covers the call site)
                    graph.add(src, dst, site(node))
                continue
            # instrument-handle mutator -> the instrument leaf lock
            if tail in INSTRUMENT_METHOD_TAILS and (
                    (kind == "attr" and base in census.instrument_attrs)
                    or (kind == "name" and base in mod_instruments)):
                graph.add(src, INSTRUMENT_NODE, site(node))
                continue
            # registry factory under a lock -> the registry lock
            callee = census.facts.callee(node)
            ctail = callee.rsplit(".", 1)[-1] if callee else None
            if ctail in INSTRUMENT_FACTORY_TAILS:
                graph.add(src, REGISTRY_NODE, site(node))
                continue
            # cross-object: self.<attr>.<method>() where the attribute's
            # class is known and the method acquires its own lock
            if kind == "attr" and base in census.attr_classes:
                target = registry.get(census.attr_classes[base])
                if target is not None:
                    tacq = _own_acquired_nodes(target)
                    for dst in tacq.get(tail, ()):
                        graph.add(src, dst, site(node))


def build_graph(paths, root: Optional[Path] = None) -> LockGraph:
    """The acquired-while-held graph over every ``.py`` under *paths*."""
    root = root or Path.cwd()
    graph = LockGraph()
    censuses: List[Tuple[str, ModuleCensus]] = []
    registry: Dict[str, ClassCensus] = {}
    for f in iter_py_files(paths):
        rel = _relpath(f, root)
        try:
            tree = ast.parse(f.read_text())
        except SyntaxError:
            continue   # the lint pass reports parse errors
        ctx = FileContext(f, rel, "", tree)
        mc = get_census(ctx)
        censuses.append((rel, mc))
        for name, census in mc.classes.items():
            # first definition wins; duplicate class names across
            # modules are resolved by whoever parsed first (lexical
            # analysis — good enough for edge discovery)
            registry.setdefault(name, census)
    for rel, mc in censuses:
        _census_edges(graph, mc, rel, registry)
    return graph


# -- blessed order I/O --------------------------------------------------------


def load_order_file(path: Path) -> Tuple[Dict[str, List[str]], Baseline]:
    if not path.exists():
        return {}, Baseline()
    data = json.loads(path.read_text())
    return data.get("order", {}), Baseline(data.get("findings", {}))


def save_order_file(path: Path, graph: LockGraph,
                    findings: List[Finding]) -> None:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.baseline_key] = counts.get(f.baseline_key, 0) + 1
    payload = {
        "comment": ("blessed lock partial order + grandfathered thread "
                    "findings of the port — regenerate with `python -m "
                    "raft_tpu_torch.analysis --threads --write-lock-order "
                    "raft_tpu_torch`"),
        "version": 1,
        "order": graph.to_order(),
        "findings": dict(sorted(counts.items())),
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2) + "\n")


def drift_findings(graph: LockGraph, order: Dict[str, List[str]],
                   order_path: Path) -> List[Finding]:
    """New edges not implied by the blessed order, and blessed edges no
    longer backed by any observed path (transitive closure on both
    sides, matching the runtime tracer's semantics)."""
    out: List[Finding] = []
    observed = graph.to_order()
    for src, dst in graph.edge_list():
        if dst in order.get(src, ()) or _has_path(order, src, dst):
            continue
        site = graph.sites.get((src, dst), "?")
        out.append(Finding(
            path=order_path.as_posix(), line=1, col=1,
            rule="lock-order-drift",
            message=(f"new acquired-while-held edge {src} -> {dst} "
                     f"(at {site}); re-bless with --write-lock-order"),
        ))
    for src, dsts in sorted(order.items()):
        for dst in dsts:
            if _has_path(observed, src, dst):
                continue
            out.append(Finding(
                path=order_path.as_posix(), line=1, col=1,
                rule="lock-order-drift",
                message=(f"stale blessed edge {src} -> {dst} no longer "
                         "observed; re-bless with --write-lock-order"),
            ))
    return out


def cycle_findings(graph: LockGraph, order_path: Path) -> List[Finding]:
    out: List[Finding] = []
    for cyc in graph.cycles():
        first = graph.sites.get((cyc[0], cyc[1]), "?")
        out.append(Finding(
            path=order_path.as_posix(), line=1, col=1,
            rule="lock-order-cycle",
            message=(f"lock-order cycle: {' -> '.join(cyc)} "
                     f"(first edge at {first}) — a cyclic order can "
                     "deadlock and is never blessed"),
        ))
    return out


# -- CLI ----------------------------------------------------------------------


def main_threads(args) -> int:
    """The ``--threads`` tier of ``python -m raft_tpu_torch.analysis``."""
    if args.list_rules:
        for r in THREAD_RULES:
            print(f"{r.name}: {r.description}")
        print("lock-order-drift: observed acquired-while-held edge "
              "diverges from the blessed order in lock_order.json")
        print("lock-order-cycle: the acquired-while-held graph has a "
              "cycle")
        return 0

    rules = THREAD_RULES
    if args.rules:
        wanted = {s.strip() for s in args.rules.split(",")}
        unknown = wanted - {r.name for r in THREAD_RULES}
        if unknown:
            print(f"unknown thread rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = [r for r in THREAD_RULES if r.name in wanted]

    order_path = args.lock_order or DEFAULT_LOCK_ORDER
    order, baseline = load_order_file(order_path)
    # graph findings name the order file as the lint findings name theirs
    shown = Path(_relpath(order_path, Path.cwd()))

    paths = [Path(p) for p in args.paths]
    use_baseline = not args.no_baseline and not args.write_lock_order
    result = lint_paths(paths, rules=rules,
                        baseline=baseline if use_baseline else None)

    graph = build_graph(paths)
    cycles = cycle_findings(graph, shown)

    if args.write_lock_order:
        if cycles:
            for f in cycles:
                print(f.render(), file=sys.stderr)
            print("analysis --threads: refusing to bless a cyclic order",
                  file=sys.stderr)
            return 1
        save_order_file(order_path, graph, result.findings)
        print(f"analysis --threads: wrote {len(graph.edge_list())} "
              f"edge(s) and {len(result.findings)} grandfathered "
              f"finding(s) to {order_path}")
        return 0

    drift = drift_findings(graph, order, shown)
    all_out = result.parse_errors + result.findings + cycles + drift
    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in all_out],
            "suppressed": result.suppressed,
            "baselined": result.baselined,
            "checked_files": result.checked_files,
            "edges": [f"{s} -> {d}" for s, d in graph.edge_list()],
            "rules": [r.name for r in rules],
        }, indent=2))
    else:
        for f in all_out:
            print(f.render())
        print(
            f"analysis --threads: checked {result.checked_files} files, "
            f"{len(graph.edge_list())} lock-order edge(s) — "
            f"{len(all_out)} finding(s), {result.suppressed} suppressed, "
            f"{result.baselined} baselined"
        )
    return 0 if not all_out else 1
