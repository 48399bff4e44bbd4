"""The port's static analysis (``raft_tpu_torch.analysis``) against the JAX
package's (``raft_tpu.analysis``), on the CPU.

* Parity, exact: the same fixture sources — the thread-rule class
  fixtures and lock-order graph fixtures of ``tests/test_threads.py``,
  the ``stale-epoch-read`` and ``sync-in-hot-path`` cases of
  ``tests/test_analysis.py`` — go through both analyzers, and the
  ``(rule, line, col)`` lists, the graph edges and the cycles are equal.
  So are both analyzers' thread findings and edges over
  ``raft_tpu_torch/`` itself.
* The port's own meanings, with their own expected findings: traced
  bodies are ``torch.compile`` / ``torch.jit`` / ``make_graphed_callables``
  functions and ``torch.cuda.graph`` blocks (each paired with the JAX
  spelling the other analyzer flags), and torch's host syncs
  (``torch.cuda.synchronize``, ``.synchronize()``, ``.cpu()``,
  ``.numpy()``).
* The CLI's exit codes (clean, drift, a cycle under
  ``--write-lock-order``), and the gates over the port: ``--threads`` and
  the lint rules over ``raft_tpu_torch`` and ``chip_smoke.py`` exit 0
  with 0 findings in an interpreter where ``import jax`` raises.
"""

import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import raft_tpu.analysis as janalysis
import raft_tpu.analysis.threads as jthreads
import raft_tpu_torch.analysis as tanalysis
import raft_tpu_torch.analysis.threads as tthreads
from raft_tpu.analysis.engine import lint_paths as j_lint_paths
from raft_tpu.analysis.engine import lint_source as j_lint_source
from raft_tpu.analysis.rules import ALL_RULES as J_ALL_RULES
from raft_tpu.analysis.threads import lock_order as jlo
from raft_tpu.analysis.threads.rules import THREAD_RULES as J_THREAD_RULES
from raft_tpu_torch.analysis.engine import lint_paths as t_lint_paths
from raft_tpu_torch.analysis.engine import lint_source as t_lint_source
from raft_tpu_torch.analysis.rules import ALL_RULES as T_ALL_RULES
from raft_tpu_torch.analysis.threads import lock_order as tlo
from raft_tpu_torch.analysis.threads.rules import THREAD_RULES as T_THREAD_RULES

REPO = Path(__file__).resolve().parents[1]
PORT_ORDER = REPO / "raft_tpu_torch" / "analysis" / "lock_order.json"
PORT_BASELINE = REPO / "raft_tpu_torch" / "analysis" / "lint_baseline.json"
SHARED_RULES = ("sync-in-hot-path", "stale-epoch-read")

# runs a module with `import jax` and `import raft_tpu` raising
NO_JAX = (
    "import runpy, sys\n"
    "class _Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'raft_tpu'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, _Block())\n"
    "sys.argv = ['raft_tpu_torch.analysis'] + sys.argv[1:]\n"
    "runpy.run_module('raft_tpu_torch.analysis', run_name='__main__')\n"
)


def keys(findings):
    return [(f.rule, f.line, f.col) for f in findings]


def j_rules(*names):
    return [r for r in J_ALL_RULES if r.name in names]


def t_rules(*names):
    return [r for r in T_ALL_RULES if r.name in names]


def both_threads(src):
    """Both analyzers' thread findings of one source, held equal."""
    jf = j_lint_source(src, rules=J_THREAD_RULES)
    tf = t_lint_source(src, rules=T_THREAD_RULES)
    assert keys(tf) == keys(jf)
    assert [f.message for f in tf] == [f.message for f in jf]
    return [f.rule for f in tf]


def both_lint(src, rule, rel="<string>"):
    src = textwrap.dedent(src)
    jf = j_lint_source(src, rules=j_rules(rule), rel=rel)
    tf = t_lint_source(src, rules=t_rules(rule), rel=rel)
    assert keys(tf) == keys(jf)
    return tf


# -- the thread rules: tests/test_threads.py's class fixtures --------------

THREAD_FIXTURES = {
    "unlocked_read_of_guarded_attr": ("""import threading
class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []
    def put(self, x):
        with self._lock:
            self._items.append(x)
    def peek(self):
        return self._items
""", ["unguarded-shared-state"]),
    "all_access_under_lock": ("""import threading
class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []
    def put(self, x):
        with self._lock:
            self._items.append(x)
    def peek(self):
        with self._lock:
            return list(self._items)
""", []),
    "init_only_attrs_not_guarded": ("""import threading
class Box:
    def __init__(self, dim):
        self._lock = threading.Lock()
        self.dim = dim
        self._n = 0
    def bump(self):
        with self._lock:
            self._n += 1
    def shape(self):
        return self.dim
""", []),
    "condition_canonicalizes_to_underlying_lock": ("""import threading
class Ex:
    def __init__(self):
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._pending = []
    def put(self, x):
        with self._work:
            self._pending.append(x)
    def flush(self):
        with self._lock:
            out, self._pending = self._pending, []
        return out
""", []),
    "nested_def_resets_held_stack": ("""import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._result = None
    def submit(self):
        with self._lock:
            def work():
                self._result = 1
            t = threading.Thread(target=work)
            t.start()
    def poll(self):
        with self._lock:
            self._result = None
""", ["unguarded-shared-state"]),
    "private_helper_inference": ("""import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._pending = []
    def _oldest(self):
        return self._pending[0]
    def tick(self):
        with self._lock:
            self._pending.append(1)
            return self._oldest()
""", []),
    "suppression": ("""import threading
class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []
    def put(self, x):
        with self._lock:
            self._items.append(x)
    def peek(self):
        return len(self._items)  # jaxlint: disable=unguarded-shared-state
""", []),
    "make_lock_and_make_condition": ("""from raft_tpu_torch.analysis.threads import runtime as lockcheck
class Ex:
    def __init__(self):
        self._lock = lockcheck.make_lock("Ex._lock")
        self._work = lockcheck.make_condition(self._lock)
        self._pending = []
    def put(self, x):
        with self._work:
            self._pending.append(x)
    def peek(self):
        return self._pending
""", ["unguarded-shared-state"]),
    "condition_wait_on_own_lock": ("""import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._n = 0
    def bump(self):
        with self._cv:
            self._n += 1
    def park(self):
        with self._cv:
            while not self._n:
                self._cv.wait(0.1)
""", []),
    "event_wait_under_lock": ("""import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._n = 0
    def bump(self):
        with self._lock:
            self._n += 1
    def park(self):
        with self._lock:
            self._stop.wait(1.0)
""", ["blocking-call-under-lock"]),
    "future_result_under_lock": ("""import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
    def get(self, fut):
        with self._lock:
            return fut.result(1.0)
""", ["blocking-call-under-lock"]),
    "thread_join_under_lock_incl_alias": ("""import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._t = threading.Thread(target=print)
    def bad_direct(self):
        with self._lock:
            self._t.join()
    def bad_alias(self):
        with self._lock:
            t = self._t
            t.join()
    def fine(self):
        with self._lock:
            t = self._t
        t.join()
""", ["blocking-call-under-lock"] * 2),
    "str_join_never_trips": ("""import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
    def fmt(self, parts):
        with self._lock:
            return ",".join(parts)
""", []),
    "wait_with_extra_lock_held": ("""import threading
class C:
    def __init__(self):
        self._a = threading.Lock()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
    def park(self):
        with self._a:
            with self._cv:
                self._cv.wait(0.1)
""", ["blocking-call-under-lock"]),
    "fsync_under_lock_outside_clean": ("""import os
import threading
class W:
    def __init__(self):
        self._lock = threading.Lock()
        self._durable = 0
    def bad(self, fd):
        with self._lock:
            os.fsync(fd)
    def good(self, fd, lsn):
        os.fsync(fd)
        with self._lock:
            self._durable = lsn
""", ["blocking-call-under-lock"]),
    "flush_under_lock": ("""import threading
class W:
    def __init__(self):
        self._lock = threading.Lock()
        self._f = open("/dev/null", "wb")
    def bad(self):
        with self._lock:
            self._f.flush()
    def fine(self):
        self._f.flush()
""", ["blocking-call-under-lock"]),
    "non_file_flush_under_lock": ("""import threading
class Batcher:
    def __init__(self, sink):
        self._lock = threading.Lock()
        self._sink = sink
    def drain(self):
        with self._lock:
            self._sink.flush()
""", []),
    "file_alias_flush_under_lock": ("""import threading
class W:
    def __init__(self):
        self._lock = threading.Lock()
    def bad(self, path):
        f = open(path, "wb")
        with self._lock:
            f.flush()
""", ["blocking-call-under-lock"]),
    "sleep_under_lock": ("""import threading
import time
class C:
    def __init__(self):
        self._lock = threading.Lock()
    def tick(self):
        with self._lock:
            time.sleep(0.01)
""", ["sleep-under-lock"]),
    "sleep_outside_lock": ("""import threading
import time
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
    def tick(self):
        with self._lock:
            self._n += 1
        time.sleep(0.01)
""", []),
}


@pytest.mark.parametrize("name", sorted(THREAD_FIXTURES))
def test_thread_rules_parity(name):
    src, expected = THREAD_FIXTURES[name]
    assert both_threads(src) == expected


# -- lock-in-traced-body: each analyzer's traced bodies ---------------------

JAX_TRACED = """import threading
import jax
_glock = threading.Lock()
@jax.jit
def f(x):
    with _glock:
        return x + 1
"""

# (source, expected (rule, line, col) of the port's analyzer)
TORCH_TRACED = {
    "compile_decorator": ("""import threading
import torch
_glock = threading.Lock()
@torch.compile
def f(x):
    with _glock:
        return x + 1
""", [("lock-in-traced-body", 6, 5)]),
    "compile_decorator_call_and_jit_script": ("""import threading
import torch
_glock = threading.Lock()
@torch.compile(mode="reduce-overhead")
def f(x):
    with _glock:
        return x + 1
@torch.jit.script
def g(x):
    _glock.acquire()
    return x
""", [("lock-in-traced-body", 6, 5), ("lock-in-traced-body", 10, 5)]),
    "call_forms": ("""import threading
import torch
from torch.cuda import make_graphed_callables
_glock = threading.Lock()
def f(x):
    with _glock:
        return x + 1
def g(x):
    with _glock:
        return x * 2
def h(x):
    with _glock:
        return x
def host(x):
    with _glock:
        return x
cf = torch.compile(f)
tg = torch.jit.trace(g, (x,))
gh, = make_graphed_callables((h,), ((x,),))
""", [("lock-in-traced-body", 6, 5), ("lock-in-traced-body", 9, 5),
      ("lock-in-traced-body", 12, 5)]),
    "cuda_graph_block_in_a_class": ("""import threading
import torch
class Rounds:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        self.graph = torch.cuda.CUDAGraph()
    def capture(self):
        with torch.cuda.graph(self.graph):
            with self._lock:
                self._n += 1
    def step(self):
        with self._lock:
            self._n += 1
        self.graph.replay()
""", [("lock-in-traced-body", 10, 13)]),
    "aliased_capture_context": ("""import threading
from torch.cuda import graph as capture
_glock = threading.Lock()
def run(g, fn):
    with capture(g):
        with _glock:
            fn()
""", [("lock-in-traced-body", 6, 9)]),
    "rebound_transform": ("""import threading
import torch
_glock = threading.Lock()
compile_ = torch.compile
@compile_
def f(x):
    with _glock:
        return x + 1
""", [("lock-in-traced-body", 7, 5)]),
    "host_code_clean": ("""import re
import threading
import torch
_glock = threading.Lock()
pat = re.compile("x")
def f(x):
    return x + 1
cf = torch.compile(f)
def run(g, x):
    with torch.cuda.graph(g):
        y = cf(x)
    with _glock:
        g.replay()
    return y
""", []),
}


def test_lock_in_traced_body_jax_spelling():
    """The JAX analyzer flags a lock in a jitted body; the port's reads
    torch's traced bodies and leaves the JAX spelling alone."""
    jf = j_lint_source(JAX_TRACED, rules=J_THREAD_RULES)
    assert keys(jf) == [("lock-in-traced-body", 6, 5)]
    assert t_lint_source(JAX_TRACED, rules=T_THREAD_RULES) == []


@pytest.mark.parametrize("name", sorted(TORCH_TRACED))
def test_lock_in_traced_body_torch_spellings(name):
    src, expected = TORCH_TRACED[name]
    assert keys(t_lint_source(src, rules=T_THREAD_RULES)) == expected
    # the JAX analyzer has no torch traced bodies
    assert [f for f in j_lint_source(src, rules=J_THREAD_RULES)
            if f.rule == "lock-in-traced-body"] == []


# -- the lock-order graph: tests/test_threads.py's fixtures -----------------

GRAPH_A = """import threading
class Outer:
    def __init__(self, inner: "Inner"):
        self._lock = threading.Lock()
        self.inner = inner
        self._n = 0
    def tick(self):
        with self._lock:
            self._n += 1
            self.inner.bump()
"""
GRAPH_B = """import threading
class Inner:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
    def bump(self):
        with self._lock:
            self._n += 1
"""
GRAPH_NESTED = """import threading
_mlock = threading.Lock()
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
    def tick(self):
        with self._lock:
            self._n += 1
            with _mlock:
                pass
"""
GRAPH_CYCLE = """import threading
class A:
    def __init__(self, b: "B"):
        self._lock = threading.Lock()
        self.b = b
        self._n = 0
    def fwd(self):
        with self._lock:
            self._n += 1
            self.b.bump()
    def bump(self):
        with self._lock:
            self._n += 1
class B:
    def __init__(self, a: "A"):
        self._lock = threading.Lock()
        self.a = a
        self._n = 0
    def bump(self):
        with self._lock:
            self._n += 1
    def back(self):
        with self._lock:
            self._n += 1
            self.a.bump()
"""
GRAPH_MODULE_CYCLE = """import threading
_a = threading.Lock()
_b = threading.Lock()
def fwd():
    with _a:
        with _b:
            pass
def back():
    with _b:
        with _a:
            pass
"""
GRAPH_METRICS = """import threading
class Svc:
    def __init__(self, reg):
        self._lock = threading.Lock()
        self._hits = reg.counter("hits")
        self._reg = reg
        self._n = 0
    def tick(self):
        with self._lock:
            self._n += 1
            self._hits.inc()
            self._reg.gauge("g")
"""

GRAPHS = {
    "cross_object": ({"outer": GRAPH_A, "inner": GRAPH_B},
                     [("Outer._lock", "Inner._lock")], 0),
    "nested_and_module_lock": ({"mod": GRAPH_NESTED},
                               [("C._lock", "mod._mlock")], 0),
    "cycle": ({"cyc": GRAPH_CYCLE},
              [("A._lock", "B._lock"), ("B._lock", "A._lock")], 1),
    "module_cycle": ({"cyc": GRAPH_MODULE_CYCLE},
                     [("cyc._a", "cyc._b"), ("cyc._b", "cyc._a")], 1),
    "metrics_leaves": ({"svc": GRAPH_METRICS},
                       [("Svc._lock", "MetricRegistry._lock"),
                        ("Svc._lock", "_Instrument._lock")], 0),
}


def _write(tmp_path, files):
    for name, src in files.items():
        (tmp_path / f"{name}.py").write_text(src)
    return tmp_path


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_lock_order_graph_parity(tmp_path, name):
    files, edges, n_cycles = GRAPHS[name]
    _write(tmp_path, files)
    jg = jlo.build_graph([tmp_path], root=tmp_path)
    tg = tlo.build_graph([tmp_path], root=tmp_path)
    assert tg.edge_list() == jg.edge_list() == edges
    assert tg.cycles() == jg.cycles()
    assert len(tg.cycles()) == n_cycles
    assert tg.sites == jg.sites


def test_drift_parity(tmp_path):
    _write(tmp_path, {"outer": GRAPH_A, "inner": GRAPH_B})
    jg = jlo.build_graph([tmp_path], root=tmp_path)
    tg = tlo.build_graph([tmp_path], root=tmp_path)
    op = tmp_path / "lock_order.json"
    orders = [
        {},                                           # the edge is new
        {"Outer._lock": ["Inner._lock"]},             # blessed exactly
        {"Outer._lock": ["Mid._lock"],                # transitively
         "Mid._lock": ["Inner._lock"]},
        {"Outer._lock": ["Inner._lock"],              # a stale edge
         "Ghost._lock": ["Inner._lock"]},
    ]
    got = []
    for order in orders:
        jf = jlo.drift_findings(jg, order, op)
        tf = tlo.drift_findings(tg, order, op)
        assert [f.message for f in tf] == [f.message for f in jf]
        got.append([f.message.split(" ")[0] for f in tf])
    # the transitive order is implied but neither of its edges is seen
    assert got == [["new"], [], ["stale", "stale"], ["stale"]]


# -- the shared lint rules: tests/test_analysis.py's cases ------------------

SERVING = "raft_tpu/serving/executor.py"

LINT_CASES = {
    "sync_loop_body": ("sync-in-hot-path", SERVING, """
        import numpy as np
        import jax

        def _drain_loop(self):
            while True:
                out = self.queue.get()
                host = np.asarray(out)
                v = out.item()
                jax.block_until_ready(out)
                out.block_until_ready()
    """, 4),
    "sync_outside_loop": ("sync-in-hot-path", SERVING, """
        import numpy as np

        def _finish(self, winner):
            host = np.asarray(winner)
            return host

        def warm(self, q0):
            self.dispatch(q0).block_until_ready()
    """, 0),
    "sync_loop_named_function": ("sync-in-hot-path",
                                 "raft_tpu/comms/frontend.py", """
        import numpy as np

        def serve_forever(q):
            for batch in q:
                np.asarray(batch)
    """, 1),
    "sync_plain_module_function": ("sync-in-hot-path",
                                   "raft_tpu/spatial/knn.py", """
        import numpy as np

        def gather(parts):
            outs = []
            for p in parts:
                outs.append(np.asarray(p))
            return outs
    """, 0),
    "sync_numpy_alias_and_while_test": ("sync-in-hot-path", SERVING, """
        import numpy as xp

        def _batch_loop(self):
            while self.flag.item():
                x = xp.array(self.next())
    """, 2),
    "sync_suppression": ("sync-in-hot-path", SERVING, """
        import numpy as np

        def _drain_loop(self):
            for fl in self.inflight:
                host = np.asarray(fl.out)  # jaxlint: disable=sync-in-hot-path
    """, 0),
    "epoch_missing": ("stale-epoch-read", "<string>", """
        def serve(result_cache, rows):
            return result_cache.lookup(rows)
    """, 1),
    "epoch_literal": ("stale-epoch-read", "<string>", """
        def serve(self, rows):
            a = self._rcache.lookup(rows, epoch=0)
            b = self._rcache.lookup(rows, epoch=None)
    """, 2),
    "epoch_threaded": ("stale-epoch-read", "<string>", """
        def serve(self, cache, rows, epoch):
            a = cache.lookup(rows, epoch=epoch)
            b = cache.lookup(rows, epoch=self._rt_epoch)
            c = cache.lookup(rows, epoch=mindex.epoch)
            d = cache.lookup(rows, epoch=epoch_fn())
            e = cache.lookup(rows, int(current_epoch))
    """, 0),
    "epoch_epochish_receiver": ("stale-epoch-read", "<string>", """
        def serve(epoch_cache, rows):
            return epoch_cache.lookup(rows)
    """, 1),
    "epoch_non_cache_receiver": ("stale-epoch-read", "<string>", """
        def resolve(registry, dns, name):
            a = registry.lookup(name)
            b = dns.lookup(name)
    """, 0),
    "epoch_suppression": ("stale-epoch-read", "<string>", """
        def serve(frozen_cache, rows):
            return frozen_cache.lookup(rows, epoch=0)  # jaxlint: disable=stale-epoch-read
    """, 0),
}


@pytest.mark.parametrize("name", sorted(LINT_CASES))
def test_lint_rules_parity(name):
    rule, rel, src, n = LINT_CASES[name]
    got = both_lint(src, rule, rel=rel)
    assert len(got) == n and all(f.rule == rule for f in got)


TORCH_SYNCS = """
    import numpy as np
    import torch

    def _drain_loop(self):
        while True:
            out = self.queue.get()
            torch.cuda.synchronize()
            self.done_event.synchronize()
            host = out.cpu()
            arr = out.numpy()
            torch.cuda.current_stream().synchronize()

    def _finish(self, out):
        torch.cuda.synchronize()
        return out.cpu().numpy()
"""


def test_sync_in_hot_path_torch_spellings():
    """torch's block_until_ready and implicit readbacks, flagged in the
    loop body only; the JAX analyzer knows none of them."""
    src = textwrap.dedent(TORCH_SYNCS)
    rule = t_rules("sync-in-hot-path")
    got = t_lint_source(src, rules=rule, rel=SERVING)
    assert [(f.line, f.col) for f in got] == [
        (8, 9), (9, 9), (10, 16), (11, 15), (12, 9)]
    assert [f.message.split(" ")[0] for f in got] == [
        "torch.cuda.synchronize()", ".synchronize()", ".cpu()",
        ".numpy()", ".synchronize()"]
    assert j_lint_source(src, rules=j_rules("sync-in-hot-path"),
                         rel=SERVING) == []
    # a plain module with unremarkable names is not a hot path
    assert t_lint_source(src.replace("_drain_loop", "gather"), rules=rule,
                         rel="raft_tpu_torch/spatial/knn.py") == []


# -- both analyzers over the port's own source -----------------------------

def test_both_analyzers_agree_on_the_port():
    """Thread findings (kept and suppressed) and the lock-order edges over
    ``raft_tpu_torch/``: equal, and the edges are the pinned order's."""
    paths = [REPO / "raft_tpu_torch"]
    jr = j_lint_paths(paths, root=REPO, rules=J_THREAD_RULES)
    tr = t_lint_paths(paths, root=REPO, rules=T_THREAD_RULES)
    assert [(f.path, *k) for f, k in zip(tr.findings, keys(tr.findings))] \
        == [(f.path, *k) for f, k in zip(jr.findings, keys(jr.findings))]
    assert tr.findings == [] and tr.parse_errors == []
    assert tr.suppressed == jr.suppressed > 0
    assert tr.checked_files == jr.checked_files
    jg = jlo.build_graph(paths, root=REPO)
    tg = tlo.build_graph(paths, root=REPO)
    assert tg.edge_list() == jg.edge_list()
    assert tg.cycles() == jg.cycles() == []
    order = json.loads(PORT_ORDER.read_text())["order"]
    assert tg.to_order() == order
    assert sum(len(v) for v in order.values()) == 12


# -- the CLI ----------------------------------------------------------------

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-c", NO_JAX, *map(str, args)],
        capture_output=True, text=True, cwd=REPO,
    )


def test_cli_write_then_clean_then_drift(tmp_path):
    _write(tmp_path, {"outer": GRAPH_A, "inner": GRAPH_B})
    op = tmp_path / "lock_order.json"
    run = lambda *extra: _cli("--threads", "--lock-order", op,  # noqa: E731
                              tmp_path, *extra)
    # an unblessed edge fails; --write-lock-order pins it; clean after
    assert run().returncode == 1
    w = run("--write-lock-order")
    assert w.returncode == 0, w.stdout + w.stderr
    data = json.loads(op.read_text())
    assert data["order"] == {"Outer._lock": ["Inner._lock"]}
    assert data["findings"] == {}
    clean = run()
    assert clean.returncode == 0, clean.stdout
    assert "0 finding(s)" in clean.stdout
    # a new nested acquisition drifts red again
    (tmp_path / "extra.py").write_text(GRAPH_A.replace("Outer", "Z"))
    p = run()
    assert p.returncode == 1 and "Z._lock -> Inner._lock" in p.stdout


def test_cli_refuses_to_bless_cycles(tmp_path):
    _write(tmp_path, {"cyc": GRAPH_MODULE_CYCLE})
    op = tmp_path / "lock_order.json"
    p = _cli("--threads", "--lock-order", op, tmp_path, "--write-lock-order")
    assert p.returncode == 1
    assert "refusing to bless a cyclic order" in p.stderr
    assert "lock-order-cycle" in p.stderr
    assert not op.exists()


def test_cli_usage_errors_and_rule_lists(tmp_path):
    assert _cli("--write-lock-order", tmp_path).returncode == 2
    assert _cli("--rules", "no-such-rule", tmp_path).returncode == 2
    assert _cli("--threads", "--rules", "no-such-rule",
                tmp_path).returncode == 2
    lint = _cli("--list-rules")
    assert lint.returncode == 0
    assert sorted(line.split(":")[0] for line in lint.stdout.splitlines()) \
        == sorted(SHARED_RULES)
    thr = _cli("--threads", "--list-rules")
    assert thr.returncode == 0
    for r in T_THREAD_RULES:
        assert f"{r.name}:" in thr.stdout
    assert "lock-order-drift:" in thr.stdout
    assert "lock-order-cycle:" in thr.stdout


def test_cli_lint_json_baseline_and_exit_codes(tmp_path):
    bad = tmp_path / "serving" / "loop.py"
    bad.parent.mkdir()
    bad.write_text(textwrap.dedent(TORCH_SYNCS))
    p = _cli("--format", "json", "--no-baseline", tmp_path)
    assert p.returncode == 1
    out = json.loads(p.stdout)
    assert len(out["findings"]) == 5 and out["checked_files"] == 1
    base = tmp_path / "base.json"
    assert _cli("--baseline", base, "--write-baseline",
                tmp_path).returncode == 0
    assert sum(json.loads(base.read_text())["findings"].values()) == 5
    p = _cli("--baseline", base, tmp_path)
    assert p.returncode == 0 and "5 baselined" in p.stdout


# -- the port's own gates ---------------------------------------------------

def test_port_threads_clean():
    """``python -m raft_tpu_torch.analysis --threads`` over the port and
    the smoke, with ``import jax`` raising: zero findings, zero drift,
    cycle-free, an empty ``findings`` baseline."""
    assert json.loads(PORT_ORDER.read_text())["findings"] == {}
    p = _cli("--threads", "raft_tpu_torch", "chip_smoke.py")
    assert p.returncode == 0, p.stdout + p.stderr
    assert re.search(r"12 lock-order edge\(s\) — 0 finding\(s\)",
                     p.stdout), p.stdout


def test_port_lint_clean():
    """The lint rules over the port and the smoke, with ``import jax``
    raising: zero findings against an empty baseline."""
    assert json.loads(PORT_BASELINE.read_text())["findings"] == {}
    p = _cli("raft_tpu_torch", "chip_smoke.py")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "— 0 finding(s)" in p.stdout and "0 baselined" in p.stdout


# -- the public surface -----------------------------------------------------

def test_public_names_match_the_jax_package():
    assert tanalysis.__all__ == janalysis.__all__
    for name in tanalysis.__all__:
        assert hasattr(tanalysis, name)
    assert tthreads.__all__ == jthreads.__all__
    assert len(tthreads.__all__) == 17
    assert [r.name for r in T_THREAD_RULES] == \
        [r.name for r in J_THREAD_RULES]
    assert {r.name for r in T_ALL_RULES} == set(SHARED_RULES)


def test_analysis_imports_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import|from) (jax|raft_tpu)(\.| |$)", re.M)
    files = sorted((REPO / "raft_tpu_torch" / "analysis").rglob("*.py"))
    assert len(files) >= 11
    for f in files:
        assert not pat.search(f.read_text()), f
