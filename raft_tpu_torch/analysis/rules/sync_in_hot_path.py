"""Rule ``sync-in-hot-path``: a host synchronization inside a
serving-loop body — the port of
``raft_tpu/analysis/rules/sync_in_hot_path.py``, with torch's spellings
of the sync added to the JAX package's.

The open-loop executor's whole throughput win
(raft_tpu_torch/serving/executor.py, docs/serving.md "Open-loop
serving") is asynchronous dispatch: the batcher keeps N batches in
flight on the card's stream and the device never waits for the host.
ONE stray host sync in a serving-loop body — a
``torch.cuda.synchronize()``, an ``.item()``, a ``.cpu()`` or an
``np.asarray`` of a device value — serializes the pipeline silently:
every dispatch then waits for the previous result's round trip, the
in-flight window collapses to 1, and measured open-loop throughput
drops to the closed-loop number while every test still passes. This is
the async sibling of ``recompile-hazard``: not wrong, just quietly 10x
slower.

Flagged — when lexically inside a ``for``/``while`` loop body that is
itself inside a *serving-loop context*:

* ``torch.cuda.synchronize()`` and ``x.synchronize()`` (an event or a
  stream), torch's ``block_until_ready``; ``x.block_until_ready()`` /
  ``jax.block_until_ready(x)``, the JAX package's spellings, still
  count, so one fixture flags the same in both analyzers;
* ``x.item()`` / ``x.tolist()`` (host readback of a device scalar);
* ``x.cpu()`` / ``x.numpy()`` (torch's implicit readback);
* ``np.asarray(x)`` / ``np.array(x)`` / ``np.copy(x)`` (implicit
  transfer + sync when ``x`` is a device array).

A *serving-loop context* is (a) any function in a module under a
``serving/`` path segment, or (b) any function named ``*_loop`` /
``serve*`` anywhere — the executor's thread bodies and anything shaped
like one. Loop bodies only: a single sync before or after the loop
(setup, final demux) is the intended pattern.

Intentional sync points — the demux conversion after readiness is
confirmed, a shutdown drain, a host list — carry
``# jaxlint: disable=sync-in-hot-path`` on the line with a reason;
everything else is a lint error (the port's baseline is empty).
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from raft_tpu_torch.analysis.rules import Rule

_HOT_FN_RE = re.compile(r"(_loop$|^serve)")
_SYNC_METHODS = {"block_until_ready", "item", "tolist", "cpu", "numpy",
                 "synchronize"}
_SYNC_FUNCTIONS = {"jax.block_until_ready", "torch.cuda.synchronize"}
_NUMPY_SYNCS = {"numpy.asarray", "numpy.array", "numpy.copy"}


def _in_serving_module(rel: str) -> bool:
    parts = rel.replace("\\", "/").split("/")
    return "serving" in parts[:-1]


class SyncInHotPathRule(Rule):
    name = "sync-in-hot-path"
    description = (
        "host sync (torch.cuda.synchronize/.item()/.cpu()/np.asarray) "
        "inside a serving-loop body — silently serializes async dispatch"
    )

    def _loop_ancestor(self, ctx, node: ast.AST) -> Optional[ast.AST]:
        """The nearest enclosing for/while statement, or None. A node
        that IS the loop's test/iter (e.g. ``while x.item():``) counts:
        it runs once per iteration too."""
        cur = ctx.facts.parent.get(node)
        while cur is not None:
            if isinstance(cur, (ast.For, ast.While, ast.AsyncFor)):
                return cur
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return None        # don't escape the defining function
            cur = ctx.facts.parent.get(cur)
        return None

    def _hot_function(self, ctx, node: ast.AST) -> Optional[str]:
        """The name of the serving-loop function lexically enclosing
        ``node``, or None when this context is not a hot path."""
        serving_mod = _in_serving_module(ctx.rel)
        cur = ctx.facts.parent.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if serving_mod or _HOT_FN_RE.search(cur.name):
                    return cur.name
                return None        # nearest function decides
            cur = ctx.facts.parent.get(cur)
        return None

    def _sync_call(self, ctx, call: ast.Call) -> Optional[str]:
        """A human-readable description of the sync this call performs,
        or None."""
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr in _SYNC_METHODS:
            # method spelling: x.synchronize() / x.item(); skip the
            # module-level functions (dotted paths below)
            d = ctx.facts.dotted(fn)
            if d is None or not d.startswith(("jax.", "numpy.", "torch.")):
                return f".{fn.attr}()"
        d = ctx.facts.dotted(fn)
        if d in _SYNC_FUNCTIONS:
            return f"{d}()"
        if d in _NUMPY_SYNCS:
            return f"{d.replace('numpy.', 'np.')}()"
        return None

    def check(self, ctx) -> Iterator:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            what = self._sync_call(ctx, node)
            if what is None:
                continue
            if self._loop_ancestor(ctx, node) is None:
                continue
            hot = self._hot_function(ctx, node)
            if hot is None:
                continue
            yield ctx.finding(
                self.name, node,
                f"{what} inside the `{hot}` serving-loop body — one "
                "host sync per iteration serializes async dispatch "
                "(the in-flight window collapses to 1); demux AFTER "
                "readiness outside the loop, or suppress if this sync "
                "is the intentional demux point",
            )


RULES = [SyncInHotPathRule()]
