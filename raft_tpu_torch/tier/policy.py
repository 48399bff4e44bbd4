"""Promotion and demotion planning — popularity with hysteresis, the port
of ``raft_tpu/tier/policy.py``.

The load signal: every tiered search records its probe histogram into
``serving_list_rows_total{shard,list}``
(:func:`raft_tpu_torch.resilience.replica.record_list_load`) and into the
store's decayed touch vector; the policy ranks lists by that vector.
Planning is host numpy only — no device state, no lock — so a control
plane can evaluate plans without owning a store.

Hysteresis is the anti-thrash rule: a cold candidate displaces the
coldest hot list only when its load beats the victim's by
``demote_margin`` (and clears ``min_touches``). Under a Zipf mix the hot
set converges to the head and one-off tail probes bounce off the margin;
``max_moves`` bounds the install traffic one cycle can queue.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch import errors

__all__ = ["PromotionPolicy"]


@dataclasses.dataclass(frozen=True)
class PromotionPolicy:
    """The hysteresis planner (see the module docstring).

    ``demote_margin`` — a candidate must carry at least this multiple
    of the victim's load (> 1 damps thrash; 1.0 = pure LFU).
    ``min_touches`` — floor on a candidate's load before it is worth a
    fetch at all (a single stray probe never promotes).
    ``max_moves`` — per-cycle cap on planned moves.
    """

    demote_margin: float = 1.25
    min_touches: float = 1.0
    max_moves: int = 4

    def __post_init__(self):
        errors.expects(self.demote_margin >= 1.0,
                       "PromotionPolicy: demote_margin=%s < 1",
                       self.demote_margin)
        errors.expects(self.max_moves >= 1,
                       "PromotionPolicy: max_moves=%d < 1",
                       self.max_moves)

    def plan(self, load: np.ndarray, slot_of: np.ndarray,
             n_slots: int) -> List[Tuple[int, Optional[int]]]:
        """Plan up to ``max_moves`` ``(promote, victim|None)`` pairs:
        first fill free slots with the hottest qualifying cold lists,
        then swap while the hottest remaining cold list beats the
        coldest hot list by the margin. ``load`` is the measured
        per-list signal; ``slot_of`` the current membership (-1 =
        cold)."""
        load = np.asarray(load, np.float64)
        slot_of = np.asarray(slot_of)
        hot_mask = slot_of >= 0
        cold = np.nonzero(~hot_mask)[0]
        cold = cold[load[cold] >= self.min_touches]
        if cold.size == 0:
            return []
        cold = cold[np.argsort(-load[cold], kind="stable")]
        moves: List[Tuple[int, Optional[int]]] = []
        free = int(n_slots) - int(hot_mask.sum())
        ci = 0
        while ci < cold.size and free > 0 and len(moves) < self.max_moves:
            moves.append((int(cold[ci]), None))
            ci += 1
            free -= 1
        hot = np.nonzero(hot_mask)[0]
        hot = hot[np.argsort(load[hot], kind="stable")]    # coldest first
        hi = 0
        while (ci < cold.size and hi < hot.size
               and len(moves) < self.max_moves):
            cand, victim = int(cold[ci]), int(hot[hi])
            if load[cand] < self.demote_margin * max(load[victim], 0.0) \
                    or load[cand] <= load[victim]:
                break          # sorted both ways: no later pair can pass
            moves.append((cand, victim))
            ci += 1
            hi += 1
        return moves

    def pick_victim(self, load: np.ndarray, slot_of: np.ndarray, *,
                    candidate_load: float,
                    exclude: Sequence[int] = ()) -> Optional[int]:
        """The fetcher's single-victim query: the coldest hot list the
        candidate beats by the margin, or ``None`` (don't thrash).
        ``exclude`` removes lists mid-plan (being promoted this cycle,
        or already nominated)."""
        if candidate_load < self.min_touches:
            return None
        load = np.asarray(load, np.float64)
        slot_of = np.asarray(slot_of)
        hot = np.nonzero(slot_of >= 0)[0]
        if exclude:
            hot = hot[~np.isin(hot, np.asarray(list(exclude)))]
        if hot.size == 0:
            return None
        victim = int(hot[np.argmin(load[hot])])
        if (candidate_load >= self.demote_margin
                * max(load[victim], 0.0)
                and candidate_load > load[victim]):
            return victim
        return None
