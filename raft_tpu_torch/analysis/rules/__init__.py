"""Rule registry — the port of ``raft_tpu/analysis/rules/__init__.py``.
Each rule module exposes RULES; this package aggregates them into
ALL_RULES in documentation order.

The port holds the two lint rules that mean the same in torch code:
``sync-in-hot-path`` and ``stale-epoch-read``. The JAX package's other
eleven police JAX tracing, x64, PRNG keys, the TPU's DCN and its compat
table, and have no counterpart here.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterator, List

if TYPE_CHECKING:
    from raft_tpu_torch.analysis.engine import FileContext, Finding


class Rule:
    """One named check. Subclasses set ``name``/``description`` and yield
    :class:`~raft_tpu_torch.analysis.engine.Finding` s from
    :meth:`check`."""

    name: str = ""
    description: str = ""

    def check(self, ctx: "FileContext") -> Iterator["Finding"]:
        raise NotImplementedError


def _collect() -> List[Rule]:
    from raft_tpu_torch.analysis.rules import (
        stale_epoch_read,
        sync_in_hot_path,
    )

    out: List[Rule] = []
    for mod in (sync_in_hot_path, stale_epoch_read):
        out.extend(mod.RULES)
    return out


ALL_RULES: List[Rule] = _collect()

__all__ = ["Rule", "ALL_RULES"]
