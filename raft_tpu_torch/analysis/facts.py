"""Pass 1 of the analyzer: per-module fact gathering — the port of
``raft_tpu/analysis/facts.py``.

Rules never re-derive module structure themselves; this pass walks the AST
once and exposes:

* import alias resolution (``import torch.nn.functional as F`` → ``F``
  means ``torch.nn.functional``; ``from torch import cuda`` → ``cuda``
  means ``torch.cuda``), so rules match *dotted origin paths*, not
  surface spellings;
* the *traced bodies*: code that runs once, when torch captures or
  compiles it, and never when the captured program replays — the body
  of a function decorated with, or passed to, ``torch.compile``,
  ``torch.jit.script`` / ``torch.jit.trace`` or
  ``torch.cuda.make_graphed_callables``, and the body of a
  ``with torch.cuda.graph(...)`` block. Host code there (a lock, a
  counter) acts at capture and guards nothing at replay, which is the
  hazard a JAX trace has;
* a parent map for ancestor queries.

This is deliberately lexical, not a type system: a method invoked *from* a
traced region in another module is not seen. The rules it feeds are linters
— suppressions and the baseline absorb the residue.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Union

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]
TracedNode = Union[FunctionNode, ast.With, ast.AsyncWith]

# Callables whose function argument (or decorated function) is compiled or
# captured, matched against the resolved dotted path: the tails alone
# ("compile", "script", "trace") are far too common to mean torch.
TRACING_TRANSFORMS = frozenset({
    "torch.compile",
    "torch.jit.script",
    "torch.jit.trace",
    "torch.cuda.make_graphed_callables",
})

# Context managers whose block is captured into a CUDA graph.
CAPTURE_CONTEXTS = frozenset({"torch.cuda.graph"})


def dotted_chain(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` Attribute/Name chain as ["a","b","c"], or None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


class ModuleFacts:
    """Everything pass-1 knows about one parsed module."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        # local name -> dotted origin ("F" -> "torch.nn.functional")
        self.aliases: Dict[str, str] = {}
        self.parent: Dict[ast.AST, ast.AST] = {}
        self.functions_by_name: Dict[str, List[ast.FunctionDef]] = {}
        self.traced: List[TracedNode] = []
        self._collect()

    # -- name resolution -----------------------------------------------------

    def dotted(self, node: ast.AST) -> Optional[str]:
        """Resolve an Attribute/Name chain to its dotted origin path,
        expanding import aliases on the root segment."""
        chain = dotted_chain(node)
        if not chain:
            return None
        root = self.aliases.get(chain[0], chain[0])
        return ".".join([root] + chain[1:])

    def callee(self, call: ast.Call) -> Optional[str]:
        return self.dotted(call.func)

    # -- collection ----------------------------------------------------------

    def _collect(self) -> None:
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.aliases[alias.asname] = alias.name
                    else:
                        # `import torch.cuda` binds only the root name
                        root = alias.name.split(".")[0]
                        self.aliases[root] = root
            elif isinstance(node, ast.ImportFrom):
                if node.level or not node.module:
                    continue  # relative imports stay local-package
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    self.aliases[local] = f"{node.module}.{alias.name}"
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions_by_name.setdefault(node.name, []).append(node)

        # transforms rebound by assignment (`capture = torch.cuda.graph`)
        # fold into the alias map, so dotted() resolves them at use
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                d = self.dotted(node.value)
                if d in TRACING_TRANSFORMS or d in CAPTURE_CONTEXTS:
                    self.aliases[node.targets[0].id] = d

        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_decorators(node)
            elif isinstance(node, ast.Call):
                self._check_transform_call(node)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                self._check_capture(node)

    def _mark_traced(self, node: TracedNode) -> None:
        if node not in self.traced:
            self.traced.append(node)

    def _is_transform(self, node: ast.AST) -> bool:
        return self.dotted(node) in TRACING_TRANSFORMS

    def _check_decorators(self, fn: ast.FunctionDef) -> None:
        # @torch.compile, @torch.compile(mode=...), @torch.jit.script
        for dec in fn.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if self._is_transform(target):
                self._mark_traced(fn)

    def _check_transform_call(self, call: ast.Call) -> None:
        # torch.compile(f), torch.jit.trace(f, example),
        # torch.cuda.make_graphed_callables((f, g), samples)
        if not self._is_transform(call.func) or not call.args:
            return
        first = call.args[0]
        cands = first.elts if isinstance(first, (ast.Tuple, ast.List)) \
            else [first]
        for arg in cands:
            if isinstance(arg, ast.Lambda):
                self._mark_traced(arg)
            elif isinstance(arg, ast.Name):
                defs = self.functions_by_name.get(arg.id)
                if defs:
                    self._mark_traced(defs[-1])

    def _check_capture(self, node: ast.With) -> None:
        for item in node.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call) \
                    and self.dotted(expr.func) in CAPTURE_CONTEXTS:
                self._mark_traced(node)
                return

    # -- traced-body queries -------------------------------------------------

    def traced_body_nodes(self, node: TracedNode):
        """All AST nodes inside a traced callable's body or a capture
        block's body (nested defs included: they are captured too when
        the outer body calls them)."""
        bodies = node.body if isinstance(node.body, list) else [node.body]
        for stmt in bodies:
            yield from ast.walk(stmt)
