"""The thread rules (the static pass of the concurrency auditor) — the
port of ``raft_tpu/analysis/threads/rules.py``.

Four checks over the per-class census
(:mod:`raft_tpu_torch.analysis.threads.census`), registered in
``THREAD_RULES`` (their own registry, run by ``python -m
raft_tpu_torch.analysis --threads``; the lint rules are separate):

* ``unguarded-shared-state`` — an attribute the class demonstrably
  guards (assigned in ``__init__``, written under an own lock
  elsewhere) is read or written WITHOUT the lock;
* ``lock-in-traced-body`` — a lock acquisition inside a traced body
  (:mod:`raft_tpu_torch.analysis.facts`: a ``torch.compile`` /
  ``torch.jit`` function, a ``make_graphed_callables`` callable, a
  ``torch.cuda.graph`` capture block): it would acquire once at capture
  and never guard the replayed program;
* ``blocking-call-under-lock`` — ``Condition.wait`` on a condition
  whose lock is NOT the one held (or while holding additional locks:
  ``wait`` parks the thread but releases only its own lock),
  ``Event.wait``, ``Future.result``, and ``Thread.join`` while holding
  a lock — each parks a thread that other threads may need the held
  lock to wake; plus the durable-IO calls — ``os.fsync`` /
  ``os.fdatasync``, and ``.flush()`` on a receiver the census knows is
  a FILE handle (any object may grow a cheap ``flush()``) — which park
  the holder behind the DISK (the WAL group-commit contract: acks are
  taken under the lock, the fsync batch runs outside it,
  docs/robustness.md "Durability");
* ``sleep-under-lock`` — ``time.sleep`` while holding a lock
  serializes every contender behind a timer.

Suppression and baselining follow the lint rules: ``# jaxlint:
disable=<rule>`` inline, counts grandfathered in the ``findings``
section of ``raft_tpu_torch/analysis/lock_order.json`` (empty: the
port's own source is clean).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set

from raft_tpu_torch.analysis.rules import Rule
from raft_tpu_torch.analysis.threads.census import (
    ClassCensus,
    get_census,
    _self_attr,
)

__all__ = ["THREAD_RULES"]


def _censuses(ctx) -> List[ClassCensus]:
    mc = get_census(ctx)
    return list(mc.classes.values()) + [mc.toplevel]


class UnguardedSharedState(Rule):
    name = "unguarded-shared-state"
    description = (
        "an attribute the class guards with a lock elsewhere is "
        "read/written without holding it"
    )

    def check(self, ctx) -> Iterator:
        for census in _censuses(ctx):
            if not census.guarded:
                continue
            for method, node, attr, kind in census.accesses:
                if attr not in census.guarded:
                    continue
                if census.own_locks_held(node):
                    continue
                lock = next(iter(census.locks.values()), "_lock")
                yield ctx.finding(
                    self.name, node,
                    f"{census.name}.{attr} is guarded (written under "
                    f"self.{lock} elsewhere) but {kind} in "
                    f"{method}() without the lock",
                )


class LockInTracedBody(Rule):
    name = "lock-in-traced-body"
    description = (
        "lock acquired inside a traced body (torch.compile/torch.jit/"
        "a CUDA graph capture: locks once at capture, guards nothing "
        "at replay)"
    )

    def check(self, ctx) -> Iterator:
        traced: Set[ast.AST] = set()
        for fn in ctx.facts.traced:
            traced.update(ctx.facts.traced_body_nodes(fn))
        if not traced:
            return
        for census in _censuses(ctx):
            for _method, with_node, key in census.acquisitions:
                if with_node in traced:
                    yield ctx.finding(
                        self.name, with_node,
                        f"lock {key.split(':', 1)[1]} acquired inside "
                        "a traced body",
                    )
            for node in census.method_of:
                if node not in traced or not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "acquire" \
                        and census.lock_key(f.value) is not None:
                    yield ctx.finding(
                        self.name, node,
                        "lock .acquire() inside a traced body",
                    )


class BlockingCallUnderLock(Rule):
    name = "blocking-call-under-lock"
    description = (
        "Condition.wait on a foreign lock, Event.wait, Future.result, "
        "Thread.join, or durable IO (os.fsync/os.fdatasync, file "
        ".flush) while holding a lock"
    )

    def check(self, ctx) -> Iterator:
        for census in _censuses(ctx):
            aliases = self._thread_aliases(census)
            file_aliases = self._file_aliases(ctx, census)
            for node, method in census.method_of.items():
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if not isinstance(f, ast.Attribute):
                    continue
                held = census.effective_held(node)
                if not held:
                    continue
                tail = f.attr
                recv_attr = _self_attr(f.value)
                if tail in ("wait", "wait_for"):
                    yield from self._check_wait(
                        ctx, census, node, method, recv_attr, held)
                elif tail == "result":
                    yield ctx.finding(
                        self.name, node,
                        f"Future.result() while holding "
                        f"{self._chain(held)} in {method}()",
                    )
                elif tail == "join":
                    is_thread = recv_attr in census.thread_attrs
                    if not is_thread and isinstance(f.value, ast.Name):
                        is_thread = f.value.id in aliases.get(method,
                                                              set())
                    if is_thread:
                        yield ctx.finding(
                            self.name, node,
                            f"Thread.join() while holding "
                            f"{self._chain(held)} in {method}()",
                        )
                elif tail in ("fsync", "fdatasync"):
                    callee = ctx.facts.callee(node)
                    if callee in ("os.fsync", "os.fdatasync"):
                        yield ctx.finding(
                            self.name, node,
                            f"{callee}() while holding "
                            f"{self._chain(held)} in {method}() — "
                            "fsync outside the lock, publish the "
                            "durable LSN under it",
                        )
                elif tail == "flush":
                    # file receivers ONLY (mirroring the fsync callee
                    # check): any object may grow a cheap .flush() —
                    # buffers, queues, loggers — and flagging those
                    # would fail the gate on non-IO code
                    is_file = recv_attr in census.file_attrs
                    if not is_file and isinstance(f.value, ast.Name):
                        is_file = f.value.id in file_aliases.get(
                            method, set())
                    if is_file:
                        yield ctx.finding(
                            self.name, node,
                            f".flush() while holding "
                            f"{self._chain(held)} in {method}() — "
                            "the holder parks behind the disk",
                        )

    def _check_wait(self, ctx, census, node, method, recv_attr, held):
        if recv_attr in census.event_attrs:
            yield ctx.finding(
                self.name, node,
                f"Event.wait() while holding {self._chain(held)} "
                f"in {method}()",
            )
            return
        if recv_attr not in census.locks:
            return   # unknown receiver: lexical limits
        underlying = f"self:{census.locks[recv_attr]}"
        others = [k for k in held if k != underlying]
        if underlying not in held:
            yield ctx.finding(
                self.name, node,
                f"Condition self.{recv_attr}.wait() without holding "
                f"its own lock in {method}()",
            )
        elif others:
            yield ctx.finding(
                self.name, node,
                f"Condition self.{recv_attr}.wait() releases only its "
                f"own lock; {self._chain(tuple(others))} stays held "
                f"while parked in {method}()",
            )

    @staticmethod
    def _chain(held) -> str:
        return " -> ".join(k.split(":", 1)[1] for k in held)

    @staticmethod
    def _file_aliases(ctx, census) -> Dict[str, Set[str]]:
        """Per method: local names bound to a file handle
        (``f = open(...)`` / ``f = self._file``)."""
        out: Dict[str, Set[str]] = {}
        for node, method in census.method_of.items():
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            is_file = _self_attr(node.value) in census.file_attrs
            if not is_file and isinstance(node.value, ast.Call):
                callee = ctx.facts.callee(node.value)
                tail = callee.rsplit(".", 1)[-1] if callee else None
                is_file = tail in ("open", "fdopen")
            if is_file:
                out.setdefault(method, set()).add(node.targets[0].id)
        return out

    @staticmethod
    def _thread_aliases(census) -> Dict[str, Set[str]]:
        """Per method: local names assigned from a thread attr
        (``t = self._thread``)."""
        out: Dict[str, Set[str]] = {}
        for node, method in census.method_of.items():
            if isinstance(node, ast.Assign) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and _self_attr(node.value) in census.thread_attrs:
                out.setdefault(method, set()).add(node.targets[0].id)
        return out


class SleepUnderLock(Rule):
    name = "sleep-under-lock"
    description = "time.sleep while holding a lock"

    def check(self, ctx) -> Iterator:
        for census in _censuses(ctx):
            for node, method in census.method_of.items():
                if not isinstance(node, ast.Call):
                    continue
                if ctx.facts.callee(node) != "time.sleep":
                    continue
                held = census.effective_held(node)
                if held:
                    chain = BlockingCallUnderLock._chain(held)
                    yield ctx.finding(
                        self.name, node,
                        f"time.sleep() while holding {chain} in "
                        f"{method}()",
                    )


THREAD_RULES: List[Rule] = [
    UnguardedSharedState(),
    LockInTracedBody(),
    BlockingCallUnderLock(),
    SleepUnderLock(),
]
