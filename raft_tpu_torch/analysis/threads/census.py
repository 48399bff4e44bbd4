"""Pass 1 of the thread tier: the per-class shared-state census — the
port of ``raft_tpu/analysis/threads/census.py`` (stdlib only, the same
census).

Built once per file (cached on the :class:`~raft_tpu_torch.analysis
.engine.FileContext` by :func:`get_census`) and shared by the thread
rules (:mod:`raft_tpu_torch.analysis.threads.rules`) and the
cross-module lock-order graph
(:mod:`raft_tpu_torch.analysis.threads.lock_order`). For every class it
records:

* **lock attributes** — ``self.X = threading.Lock()`` / ``RLock`` /
  ``lockcheck.make_lock(...)`` in ``__init__``; Conditions
  (``threading.Condition(self._lock)`` / ``make_condition``) map to
  their UNDERLYING lock, so ``with self._work:`` and
  ``with self._lock:`` are the same census region (the executor's
  two-conditions-one-lock idiom);
* **guarded attributes** — assigned in ``__init__`` AND written at
  least once under an own lock outside ``__init__``. The write
  requirement is what keeps immutable configuration (``self.dim``,
  handles cached at init) out of the census: "read under a lock
  somewhere" proves nothing, "the class bothers to lock its writes"
  is the discipline being checked;
* **held-stack per AST node** — which own/foreign locks are lexically
  held at every node of every method (nested ``with`` aware; nested
  ``def`` bodies reset the stack — they run on another thread);
* **lock-held helpers** — a method whose intra-class call sites are
  ALL under a lock is treated as executing under it (the documented
  "under _lock" helper idiom: ``_flush_wait_s``, ``_sync_gauges``,
  ``_l1_put``), to fixpoint;
* **attribute classes** — ``self.admission`` →
  ``AdmissionController``, resolved from ``__init__`` parameter
  annotations (string annotations included) and direct constructions,
  so cross-object acquisitions (``with self.hedge._lock:``) and
  calls into lock-acquiring methods resolve to graph nodes;
* **metric-instrument attributes** — attrs whose init value contains
  ``registry.counter/gauge/histogram(...)`` calls (the cached-handle
  idiom); ``.inc/.set/.observe`` on them under a lock is an edge to
  the instrument leaf lock;
* **thread attributes** — ``self.X = threading.Thread(...)``, so the
  blocking-call rule flags ``.join()`` only on receivers that are
  actually threads (never ``",".join``);
* **file attributes** — ``self.X = open(...)`` / ``os.fdopen(...)``,
  so the blocking-call rule flags ``.flush()`` only on receivers that
  are actually file handles (a buffer/queue/logger ``flush()`` under a
  lock parks behind nothing).

Deliberately lexical, like :mod:`raft_tpu_torch.analysis.facts`: dynamic
dispatch, locks passed between objects, and module-global mutation are
out of scope — suppressions and the ``lock_order.json`` baseline
absorb the residue.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from raft_tpu_torch.analysis.facts import ModuleFacts

__all__ = ["ClassCensus", "ModuleCensus", "get_census"]

LOCK_TAILS = frozenset({"Lock", "RLock", "make_lock"})
COND_TAILS = frozenset({"Condition", "make_condition"})
EVENT_TAILS = frozenset({"Event"})
THREAD_TAILS = frozenset({"Thread"})
FILE_TAILS = frozenset({"open", "fdopen"})

# container mutators that count as WRITES to the attribute holding the
# container (the census cares about mutation, not rebinding)
MUTATOR_METHODS = frozenset({
    "append", "appendleft", "extend", "insert", "remove", "pop",
    "popleft", "popitem", "clear", "update", "setdefault", "add",
    "discard", "sort",
})

# registry factory tails: a call like reg.counter(...) in an __init__
# value marks the attr as a cached instrument handle (or container of)
INSTRUMENT_FACTORY_TAILS = frozenset({"counter", "gauge", "histogram"})

# typing tokens that must not be mistaken for a class in an annotation
_TYPING_TOKENS = frozenset({
    "Optional", "Union", "Dict", "List", "Set", "Tuple", "Any",
    "Callable", "Sequence", "Mapping", "Iterable", "Iterator", "Type",
    "FrozenSet", "Deque", "None", "True", "False",
})


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` -> ``"X"`` (exactly one level), else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _annotation_class(ann: ast.AST) -> Optional[str]:
    """The first class-looking token of an annotation, string
    annotations (``"HedgePolicy | float | None"``) included."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        text = ann.value
    else:
        try:
            text = ast.unparse(ann)
        except Exception:   # noqa: BLE001 — annotation exotica
            return None
    for tok in _tokens(text):
        tail = tok.rsplit(".", 1)[-1]
        if tail in _TYPING_TOKENS:
            continue
        if tail[:1].isupper():
            return tail
    return None


def _tokens(text: str) -> List[str]:
    out, cur = [], []
    for ch in text:
        if ch.isalnum() or ch in "._":
            cur.append(ch)
        elif cur:
            out.append("".join(cur))
            cur = []
    if cur:
        out.append("".join(cur))
    return out


@dataclasses.dataclass
class LockSite:
    """One lexical acquisition: a ``with`` item resolving to a lock."""

    node: ast.AST              # the with-statement
    expr: ast.AST              # the context expression
    key: str                   # census lock key (see ClassCensus.locks)


class ClassCensus:
    """Everything the thread tier knows about one class."""

    def __init__(self, node: ast.ClassDef, facts: ModuleFacts,
                 module: "ModuleCensus"):
        self.node = node
        self.name = node.name
        self.facts = facts
        self.module = module
        self.bases: List[str] = [
            b.rsplit(".", 1)[-1]
            for b in (facts.dotted(base) for base in node.bases)
            if b
        ]
        # attr -> canonical OWN lock attr ("_work" -> "_lock");
        # a Condition with no explicit lock canonicalizes to itself
        self.locks: Dict[str, str] = {}
        self.event_attrs: Set[str] = set()
        self.thread_attrs: Set[str] = set()
        self.file_attrs: Set[str] = set()
        self.instrument_attrs: Set[str] = set()
        self.attr_classes: Dict[str, str] = {}
        self.init_attrs: Set[str] = set()
        self.methods: Dict[str, ast.FunctionDef] = {
            n.name: n for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        # node -> (own locks held, foreign lock keys held) at that node
        self.held_at: Dict[ast.AST, Tuple[str, ...]] = {}
        self.method_of: Dict[ast.AST, str] = {}
        self.acquisitions: List[Tuple[str, ast.AST, str]] = []
        #                    (method, with-node, lock key)
        # method -> own locks inferred ALWAYS held at entry (helpers)
        self.inferred_held: Dict[str, Tuple[str, ...]] = {}
        self.guarded: Set[str] = set()
        # attr accesses outside __init__: (method, node, attr, kind)
        self.accesses: List[Tuple[str, ast.AST, str, str]] = []
        self._scan_init()
        self._scan_thread_attrs()
        self._walk_methods()
        self._infer_helpers()
        self._infer_guarded()

    def owner_of(self, lock_attr: str) -> str:
        """The class whose ``__init__`` constructs ``lock_attr`` —
        this class, or the nearest same-module base (the
        ``Counter``/``_Instrument`` subclass idiom), for stable graph
        node names."""
        if lock_attr in self.locks:
            return self.name
        for base in self.bases:
            bc = self.module.classes.get(base)
            if bc is not None and lock_attr in bc.locks:
                return bc.owner_of(lock_attr)
        return self.name

    def _scan_thread_attrs(self) -> None:
        """``self.X = threading.Thread(...)`` / ``open(...)`` in ANY
        method marks a thread/file attr (the compactor assigns its
        worker in ``submit``, not ``__init__``; the WAL writer rebinds
        its segment handle on rotation)."""
        for fn in self.methods.values():
            for stmt in ast.walk(fn):
                if not isinstance(stmt, ast.Assign) or not isinstance(
                        stmt.value, ast.Call):
                    continue
                callee = self.facts.callee(stmt.value)
                tail = callee.rsplit(".", 1)[-1] if callee else None
                if tail in THREAD_TAILS:
                    into = self.thread_attrs
                elif tail in FILE_TAILS:
                    into = self.file_attrs
                else:
                    continue
                for tgt in stmt.targets:
                    attr = _self_attr(tgt)
                    if attr is not None:
                        into.add(attr)

    # -- __init__ scan --------------------------------------------------------

    def _scan_init(self) -> None:
        init = self.methods.get("__init__")
        if init is None:
            return
        for stmt in ast.walk(init):
            targets: List[ast.AST] = []
            value: Optional[ast.AST] = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            for tgt in targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                self.init_attrs.add(attr)
                self._classify_init_value(attr, value, init)

    def _classify_init_value(self, attr: str, value: ast.AST,
                             init: ast.FunctionDef) -> None:
        tail = None
        if isinstance(value, ast.Call):
            callee = self.facts.callee(value)
            tail = callee.rsplit(".", 1)[-1] if callee else None
        if tail in LOCK_TAILS:
            self.locks[attr] = attr
            return
        if tail in COND_TAILS:
            under = attr
            if isinstance(value, ast.Call) and value.args:
                base = _self_attr(value.args[0])
                if base is not None:
                    under = self.locks.get(base, base)
            self.locks[attr] = under
            return
        if tail in EVENT_TAILS:
            self.event_attrs.add(attr)
            return
        if tail in THREAD_TAILS:
            self.thread_attrs.add(attr)
            return
        # cached instrument handles: any registry-factory call inside
        # the value (covers dict/comprehension containers)
        for sub in ast.walk(value):
            if isinstance(sub, ast.Call):
                c = self.facts.callee(sub)
                if c and c.rsplit(".", 1)[-1] in INSTRUMENT_FACTORY_TAILS:
                    self.instrument_attrs.add(attr)
                    break
        # attr -> class: direct construction, or a parameter (possibly
        # wrapped in a default-if-None expression) with an annotation
        if tail and tail[:1].isupper():
            self.attr_classes[attr] = tail
            return
        ann_by_param = self._param_annotations(init)
        names = {n.id for n in ast.walk(value)
                 if isinstance(n, ast.Name)} if value is not None else set()
        hits = [cls for p, cls in ann_by_param.items() if p in names]
        if len(set(hits)) == 1:
            self.attr_classes[attr] = hits[0]

    def _param_annotations(self, fn: ast.FunctionDef) -> Dict[str, str]:
        out: Dict[str, str] = {}
        a = fn.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.annotation is not None:
                cls = _annotation_class(p.annotation)
                if cls is not None:
                    out[p.arg] = cls
        return out

    # -- lock-expression resolution -------------------------------------------

    def lock_key(self, expr: ast.AST) -> Optional[str]:
        """Resolve a with-item / receiver expression to a census lock
        key: ``"self:<canonical attr>"`` for own locks,
        ``"ext:<Class>.<attr>"`` for cross-object acquisitions,
        ``"mod:<var>"`` for module-level locks."""
        attr = _self_attr(expr)
        if attr is not None:
            canon = self.locks.get(attr)
            if canon is not None:
                return f"self:{canon}"
            # `with self._lock:` in a subclass whose lock lives in the
            # base __init__ (Counter/_Instrument): name-based fallback
            if "lock" in attr:
                return f"self:{attr}"
            return None
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Attribute)):
            base = _self_attr(expr.value)
            if base is not None:
                cls = self.attr_classes.get(base)
                if cls is not None and "lock" in expr.attr:
                    return f"ext:{cls}.{expr.attr}"
        if isinstance(expr, ast.Name):
            if expr.id in self.module.module_locks:
                return f"mod:{expr.id}"
        return None

    # -- the held-stack walk --------------------------------------------------

    def _walk_methods(self) -> None:
        for name, fn in self.methods.items():
            for stmt in fn.body:
                self._walk(stmt, (), name)

    def _walk(self, node: ast.AST, held: Tuple[str, ...],
              method: str) -> None:
        self.held_at[node] = held
        self.method_of[node] = method
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # a nested def runs later, usually on ANOTHER thread
            # (Thread(target=work)) — its body starts with nothing held
            for d in getattr(node, "decorator_list", []):
                self._walk(d, held, method)
            body = node.body if isinstance(node.body, list) \
                else [node.body]
            for stmt in body:
                self._walk(stmt, (), method)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for item in node.items:
                self._walk(item.context_expr, held, method)
                key = self.lock_key(item.context_expr)
                if key is not None:
                    self.acquisitions.append((method, node, key))
                    inner = inner + (key,)
            for stmt in node.body:
                self._walk(stmt, inner, method)
            return
        for child in ast.iter_child_nodes(node):
            self._walk(child, held, method)

    # -- inference ------------------------------------------------------------

    def effective_held(self, node: ast.AST) -> Tuple[str, ...]:
        """Lexical held stack plus the enclosing method's inferred
        always-held locks (helpers called only under a lock)."""
        held = self.held_at.get(node, ())
        method = self.method_of.get(node)
        if method is not None:
            inferred = self.inferred_held.get(method, ())
            held = tuple(k for k in inferred if k not in held) + held
        return held

    def own_locks_held(self, node: ast.AST) -> Tuple[str, ...]:
        return tuple(k for k in self.effective_held(node)
                     if k.startswith("self:"))

    def _infer_helpers(self) -> None:
        """Fixpoint: a method whose intra-class call sites ALL hold a
        common own lock executes under it."""
        # method -> [(caller, call node), ...]
        sites: Dict[str, List[Tuple[str, ast.AST]]] = {}
        for node, method in self.method_of.items():
            if isinstance(node, ast.Call):
                callee = _self_attr(node.func)
                # PRIVATE methods only: a public method with internal
                # call sites is still part of the external API, and
                # inferring "always under the lock" from internal
                # callers alone would silence real findings
                if callee in self.methods and callee != "__init__" \
                        and callee.startswith("_"):
                    sites.setdefault(callee, []).append((method, node))
        for _ in range(8):
            changed = False
            for callee, calls in sites.items():
                common: Optional[Set[str]] = None
                for caller, call in calls:
                    held = set(self.held_at.get(call, ()))
                    held |= set(self.inferred_held.get(caller, ()))
                    held = {k for k in held if k.startswith("self:")}
                    common = held if common is None else common & held
                inferred = tuple(sorted(common or ()))
                if inferred and inferred != self.inferred_held.get(callee):
                    self.inferred_held[callee] = inferred
                    changed = True
            if not changed:
                break

    def _attr_accesses(self) -> None:
        """Populate ``self.accesses`` with (method, node, attr, kind)
        for every ``self.X`` touch outside ``__init__``."""
        for name, fn in self.methods.items():
            if name == "__init__":
                continue
            for node in ast.walk(fn):
                if isinstance(node, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign)):
                    targets = (node.targets
                               if isinstance(node, ast.Assign)
                               else [node.target])
                    for tgt in targets:
                        for t in ast.walk(tgt):
                            attr = _self_attr(t)
                            if attr is not None and isinstance(
                                    getattr(t, "ctx", None), ast.Store):
                                self.accesses.append(
                                    (name, t, attr, "write"))
                elif isinstance(node, (ast.Subscript,)):
                    if isinstance(node.ctx, (ast.Store, ast.Del)):
                        attr = _self_attr(node.value)
                        if attr is not None:
                            self.accesses.append(
                                (name, node, attr, "write"))
                elif isinstance(node, ast.Call):
                    f = node.func
                    if (isinstance(f, ast.Attribute)
                            and f.attr in MUTATOR_METHODS):
                        attr = _self_attr(f.value)
                        if attr is not None:
                            self.accesses.append(
                                (name, node, attr, "write"))
                elif isinstance(node, ast.Attribute):
                    attr = _self_attr(node)
                    if attr is not None and isinstance(
                            node.ctx, ast.Load):
                        self.accesses.append((name, node, attr, "read"))

    def _infer_guarded(self) -> None:
        if not self.locks:
            return
        self._attr_accesses()
        candidates = (self.init_attrs - set(self.locks)
                      - self.event_attrs)
        for _method, node, attr, kind in self.accesses:
            if kind == "write" and attr in candidates \
                    and self.own_locks_held(node):
                self.guarded.add(attr)


class ModuleCensus:
    """All class censuses of one module plus its module-level locks and
    module-level-function held stacks."""

    def __init__(self, tree: ast.Module, facts: ModuleFacts,
                 module_name: str = "<module>"):
        self.tree = tree
        self.facts = facts
        self.module_name = module_name
        # module-global lock vars: name -> canonical name (conditions
        # on a module lock canonicalize like class attrs)
        self.module_locks: Dict[str, str] = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                callee = facts.callee(node.value)
                tail = callee.rsplit(".", 1)[-1] if callee else None
                if tail in LOCK_TAILS or tail in COND_TAILS:
                    name = node.targets[0].id
                    self.module_locks[name] = name
        self.classes: Dict[str, ClassCensus] = {}
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = ClassCensus(node, facts, self)
        # module-level functions get a held-stack walk through a
        # synthetic lock-less census (module locks still resolve)
        self.toplevel = _ToplevelCensus(tree, facts, self)

    def lock_node_name(self, census: Optional[ClassCensus],
                       key: str) -> str:
        """Census lock key -> global graph node name."""
        scope, _, rest = key.partition(":")
        if scope == "self" and census is not None:
            return f"{census.owner_of(rest)}.{rest}"
        if scope == "ext":
            return rest
        if scope == "mod":
            return f"{self.module_name}.{rest}"
        return rest


class _ToplevelCensus(ClassCensus):
    """Held-stack walk for module-level functions: module locks only
    (``_mseries``'s ``with _mseries_lock:`` idiom)."""

    def __init__(self, tree: ast.Module, facts: ModuleFacts,
                 module: ModuleCensus):
        # hand-rolled minimal init: no class node, no init scan
        self.node = None
        self.name = module.module_name
        self.facts = facts
        self.module = module
        self.bases = []
        self.locks = {}
        self.event_attrs = set()
        self.thread_attrs = set()
        self.file_attrs = set()
        self.instrument_attrs = set()
        self.attr_classes = {}
        self.init_attrs = set()
        self.methods = {
            n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        self.held_at = {}
        self.method_of = {}
        self.acquisitions = []
        self.inferred_held = {}
        self.guarded = set()
        self.accesses = []
        self._walk_methods()
        self._infer_helpers()


def get_census(ctx) -> ModuleCensus:
    """The file's :class:`ModuleCensus`, built once and cached on the
    :class:`~raft_tpu_torch.analysis.engine.FileContext`."""
    census = getattr(ctx, "_thread_census", None)
    if census is None:
        module_name = ctx.rel.rsplit("/", 1)[-1].removesuffix(".py")
        census = ModuleCensus(ctx.tree, ctx.facts, module_name)
        ctx._thread_census = census
    return census
