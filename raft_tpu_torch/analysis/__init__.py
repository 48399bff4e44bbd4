"""Static analysis of the port — the counterpart of ``raft_tpu/analysis``
for the parts that mean the same in torch code. Stdlib only: it imports
neither torch nor JAX.

**The lint rules** (:mod:`raft_tpu_torch.analysis.rules`):
``sync-in-hot-path`` (a host sync — ``torch.cuda.synchronize``,
``.item()``, ``.cpu()``, ``np.asarray`` — inside a serving-loop body)
and ``stale-epoch-read`` (a result-cache lookup that threads no live
mutation epoch). The JAX package's other rules, and its jaxpr program
auditor, police JAX tracing and have no counterpart here.

**The concurrency auditor** (:mod:`raft_tpu_torch.analysis.threads`): a
per-class shared-state census feeding four lock-discipline rules
(``unguarded-shared-state``, ``lock-in-traced-body``,
``blocking-call-under-lock``, ``sleep-under-lock``), a cross-module
acquired-while-held lock-order graph with cycle detection and drift
discipline against ``raft_tpu_torch/analysis/lock_order.json``, and the
:class:`~raft_tpu_torch.analysis.threads.runtime.TracedLock` runtime
tracer (``RAFT_TPU_LOCKCHECK=1``) that asserts the same pinned order
under real interleavings.

CLI: ``python -m raft_tpu_torch.analysis [paths] [--format json]
[--baseline F] [--no-baseline] [--write-baseline] [--rules a,b]
[--list-rules]`` for the lint rules; ``--threads [--lock-order F]
[--write-lock-order]`` for the concurrency auditor. Per-line
suppression: ``# jaxlint: disable=<rule>[,<rule>]`` (the JAX package's
marker, so one source runs through both analyzers unchanged).
"""

from raft_tpu_torch.analysis.engine import (
    Baseline,
    Finding,
    LintResult,
    lint_file,
    lint_paths,
    lint_source,
    main,
)
from raft_tpu_torch.analysis.facts import ModuleFacts

__all__ = [
    "Baseline",
    "Finding",
    "LintResult",
    "ModuleFacts",
    "lint_file",
    "lint_paths",
    "lint_source",
    "main",
]
