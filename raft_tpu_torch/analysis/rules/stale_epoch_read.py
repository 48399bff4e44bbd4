"""Rule ``stale-epoch-read``: a result-cache lookup that does not
thread the current mutation epoch — the port of
``raft_tpu/analysis/rules/stale_epoch_read.py`` (framework-free, the
same rule).

The hot-traffic result cache (raft_tpu_torch/serving/result_cache.py,
docs/serving.md "Hot traffic") is invalidated by MUTATION EPOCH, not by
key: every entry is stamped with its writer's epoch, and a lookup that
presents a newer epoch treats the entry as stale. That whole contract
rests on the call site actually threading a LIVE epoch value — the one
way to silently bypass invalidation is a lookup that pins the epoch
(``cache.lookup(rows, epoch=0)``) or omits it through a forwarding
layer: every mutation still bumps the counter, but the reader never
presents it, so pre-write results keep serving forever (the hazard
the mutation chaos tests pin).

Flagged, for calls of a ``lookup`` method on a cache-shaped receiver
(a dotted name containing ``cache`` — ``result_cache.lookup``,
``self._rcache.lookup``):

* no argument references an epoch-carrying value (no ``epoch=`` keyword
  and no positional argument whose expression mentions an
  ``epoch``-ish name) — the lookup cannot be presenting the current
  epoch;
* ``epoch=<literal>`` (an int or ``None`` constant) — a pinned epoch
  is the invalidation bypass in its most direct spelling.

``epoch=self._epoch_fn()``, ``epoch=mindex.epoch``, ``epoch=ep`` are
all clean — any name or attribute mentioning ``epoch`` counts as
threading one. A GENUINELY frozen index (no mutation path exists, the
constant is the contract) suppresses inline with
``# jaxlint: disable=stale-epoch-read``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from raft_tpu_torch.analysis.rules import Rule

_CACHE_RE = re.compile(r"cache", re.IGNORECASE)
_EPOCH_RE = re.compile(r"epoch", re.IGNORECASE)


def _dotted_name(node: ast.AST) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return "_".join(reversed(parts))
    return None


def _mentions_epoch(call: ast.Call) -> bool:
    """True when any ARGUMENT of ``call`` carries an epoch-ish value
    (``epoch``, ``self._rt_epoch``, ``epoch_fn()``...). Only the
    arguments are walked — an epoch-suggestive RECEIVER name
    (``epoch_cache.lookup(rows)``) threads nothing and must still
    flag."""
    roots: list = list(call.args)
    for kw in call.keywords:
        if kw.arg and _EPOCH_RE.search(kw.arg):
            return True
        roots.append(kw.value)
    for root in roots:
        for n in ast.walk(root):
            if isinstance(n, ast.Name) and _EPOCH_RE.search(n.id):
                return True
            if isinstance(n, ast.Attribute) and _EPOCH_RE.search(n.attr):
                return True
    return False


class StaleEpochReadRule(Rule):
    name = "stale-epoch-read"
    description = (
        "result-cache lookup without a live mutation epoch — "
        "invalidation bypassed, pre-write results serve forever"
    )

    def check(self, ctx) -> Iterator:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not (isinstance(fn, ast.Attribute)
                    and fn.attr == "lookup"):
                continue
            recv = _dotted_name(fn.value)
            if recv is None or not _CACHE_RE.search(recv):
                continue
            epoch_kw = next(
                (kw for kw in node.keywords if kw.arg == "epoch"), None
            )
            if epoch_kw is not None and isinstance(
                epoch_kw.value, ast.Constant
            ):
                yield ctx.finding(
                    self.name, node,
                    f"{recv}.lookup(epoch={epoch_kw.value.value!r}) "
                    "pins the mutation epoch to a constant — every "
                    "write still bumps the counter but this reader "
                    "never presents it, so stale entries serve "
                    "forever; thread the live epoch (suppress only "
                    "for a genuinely frozen index)",
                )
                continue
            if not _mentions_epoch(node):
                yield ctx.finding(
                    self.name, node,
                    f"{recv}.lookup(...) threads no mutation epoch — "
                    "epoch-stamped invalidation is bypassed and "
                    "pre-write results can keep serving after an "
                    "upsert/delete/compact; pass epoch=<current "
                    "epoch> (docs/serving.md 'Hot traffic')",
                )


RULES = [StaleEpochReadRule()]
