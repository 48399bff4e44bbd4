"""Popularity-tiered two-tier slab storage — the port of
``raft_tpu/tier``: cold IVF lists in host RAM, a hot working set on the
card, promotion and demotion as flips of the tensors the unchanged
grouped search reads.

* :class:`TieredListStore` — the store: host cold authority, hot-slot
  view index, copy-publish installs, mutation-epoch invalidation, the
  measured recall guardrail;
* :class:`SlabFetcher` — the async host-to-device promotion worker
  (bounded queue, install window, flight-recorded fetch spans);
* :class:`PromotionPolicy` — hysteresis planning over the measured
  per-list load signal.
"""

from raft_tpu_torch.tier.fetch import SlabFetcher
from raft_tpu_torch.tier.policy import PromotionPolicy
from raft_tpu_torch.tier.store import TieredListStore, TierRuntime, TierStats

__all__ = [
    "PromotionPolicy",
    "SlabFetcher",
    "TierRuntime",
    "TierStats",
    "TieredListStore",
]
