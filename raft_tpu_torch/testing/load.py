"""Deterministic open-loop load generation for the serving executor —
the port of ``raft_tpu/testing/load.py`` (numpy only; the same seed
gives the same schedule, bit for bit).

Closed-loop measurement (dispatch, wait, dispatch) can never see the
failure mode production serving actually has: arrivals do not wait for
the server. An OPEN-LOOP generator fires requests on a schedule drawn
from the offered load regardless of completions, so queueing delay,
admission shedding, and the latency/throughput curve near saturation
become measurable (docs/serving.md "Open-loop serving"; the classic
closed-vs-open distinction — a closed loop at rate R self-throttles the
moment latency grows, hiding exactly the regime the p99 lives in).

Everything is SEEDED: a schedule is a pure function of
``(rate, n, seed)``, so a bench row or chaos test replays its arrival
process bit-for-bit .

* :func:`poisson_arrivals` — exponential inter-arrival gaps at the
  offered rate (memoryless arrivals — the standard open-loop traffic
  model), optional per-request size mix, optional ZIPF-skewed
  repeated-query mix (``zipf_s``/``n_templates``: each request draws a
  template id from a power-law over a query-template pool — the
  million-user hot-traffic shape the result cache and coalescer are
  built for, docs/serving.md "Hot traffic");
* :class:`ArrivalSchedule` — the materialized schedule (offsets +
  per-request row counts + optional per-request template ids);
* :func:`replay` — fire ``submit(i, size)`` at each scheduled instant
  against the wall clock, NEVER waiting on results; when the generator
  falls behind (a stalled submit path) it fires immediately and
  records the lag rather than silently re-shaping the offered load.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch import errors

__all__ = ["ArrivalSchedule", "poisson_arrivals", "replay",
           "zipf_template_weights"]


@dataclasses.dataclass(frozen=True)
class ArrivalSchedule:
    """A deterministic open-loop arrival schedule.

    ``times_s`` are non-decreasing offsets from the replay start;
    ``sizes`` is the per-request query-row count (the executor packs
    them into shape buckets regardless — sizes model the client mix,
    not the dispatch shape). ``template_ids`` (optional) is the
    per-request QUERY-TEMPLATE id of a repeated-query mix
    (``poisson_arrivals(zipf_s=...)``): the caller maps each id to a
    fixed query vector from its template pool, so a Zipf-hot template
    re-arrives as the bitwise-identical query — exactly what the
    result cache's exact tier and the coalescer key on."""

    times_s: np.ndarray   # (n,) float64, non-decreasing, >= 0
    sizes: np.ndarray     # (n,) int64, >= 1
    template_ids: Optional[np.ndarray] = None   # (n,) int64, >= 0

    def __post_init__(self):
        errors.expects(
            self.times_s.ndim == 1 and self.sizes.shape ==
            self.times_s.shape,
            "ArrivalSchedule: times %s and sizes %s must be equal-length "
            "1-d", self.times_s.shape, self.sizes.shape,
        )
        errors.expects(
            self.times_s.size == 0 or (
                float(self.times_s[0]) >= 0.0
                and bool((np.diff(self.times_s) >= 0).all())
            ),
            "ArrivalSchedule: times must be non-decreasing and >= 0",
        )
        errors.expects(
            self.times_s.size == 0 or int(self.sizes.min()) >= 1,
            "ArrivalSchedule: sizes must be >= 1",
        )
        if self.template_ids is not None:
            errors.expects(
                self.template_ids.shape == self.times_s.shape,
                "ArrivalSchedule: template_ids %s must match times %s",
                self.template_ids.shape, self.times_s.shape,
            )
            errors.expects(
                self.template_ids.size == 0
                or int(self.template_ids.min()) >= 0,
                "ArrivalSchedule: template_ids must be >= 0",
            )

    @property
    def n_requests(self) -> int:
        return int(self.times_s.size)

    @property
    def n_rows(self) -> int:
        return int(self.sizes.sum())

    @property
    def duration_s(self) -> float:
        return float(self.times_s[-1]) if self.times_s.size else 0.0

    @property
    def offered_qps(self) -> float:
        """Offered load in query ROWS per second over the schedule span
        (the serving throughput unit: a size-8 request is 8 queries)."""
        span = self.duration_s
        return self.n_rows / span if span > 0 else float("inf")


def zipf_template_weights(n_templates: int, zipf_s: float) -> np.ndarray:
    """The normalized Zipf(``s``) popularity law over a template pool:
    ``p(rank i) ∝ (i + 1)^-s``. At s≈1.1 (the classic web-traffic
    skew) a few head templates carry most of the offered load — the
    regime where the result cache's hit rate comes from."""
    errors.expects(n_templates >= 1,
                   "zipf_template_weights: n_templates=%d < 1",
                   n_templates)
    errors.expects(zipf_s >= 0.0,
                   "zipf_template_weights: zipf_s=%s < 0 is not a "
                   "popularity skew", zipf_s)
    w = (np.arange(1, n_templates + 1, dtype=np.float64)
         ** -float(zipf_s))
    return w / w.sum()


def poisson_arrivals(rate_rps: float, n_requests: int, *, seed: int,
                     sizes: "int | Sequence[int]" = 1,
                     size_weights: Optional[Sequence[float]] = None,
                     zipf_s: Optional[float] = None,
                     n_templates: int = 0,
                     ) -> ArrivalSchedule:
    """A seeded Poisson arrival schedule: ``n_requests`` arrivals whose
    inter-arrival gaps are iid Exponential(``rate_rps``) — ``rate_rps``
    is REQUESTS per second (multiply by the mean size for rows/s).

    ``sizes``: a constant per-request row count, or a sequence to
    sample from (optionally ``size_weights``-weighted) — the client
    mix.

    ``zipf_s`` (with ``n_templates``): the REPEATED-QUERY mix
    — each request additionally draws a template id from
    :func:`zipf_template_weights` over a pool of ``n_templates`` query
    templates, landed in ``template_ids``. The caller maps ids to
    fixed query vectors, so hot templates recur bitwise-identically —
    realistic Zipf-skewed traffic for the result cache / coalescing
    bench (``zipf_hot_traffic``).

    Fully deterministic in ``(rate_rps, n_requests, seed, sizes,
    size_weights, zipf_s, n_templates)`` — the template draw happens
    AFTER the gap and size draws on the same stream, so adding the mix
    never perturbs an existing schedule's times or sizes.
    """
    errors.expects(rate_rps > 0, "poisson_arrivals: rate_rps=%s <= 0",
                   rate_rps)
    errors.expects(n_requests >= 1,
                   "poisson_arrivals: n_requests=%d < 1", n_requests)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / float(rate_rps), size=n_requests)
    times = np.cumsum(gaps)
    times -= times[0]                       # first arrival at t=0
    if isinstance(sizes, (int, np.integer)):
        sz = np.full(n_requests, int(sizes), np.int64)
    else:
        choices = np.asarray(list(sizes), np.int64)
        p = None
        if size_weights is not None:
            p = np.asarray(list(size_weights), np.float64)
            p = p / p.sum()
        sz = rng.choice(choices, size=n_requests, p=p)
    tmpl = None
    if zipf_s is not None:
        errors.expects(
            n_templates >= 1,
            "poisson_arrivals: zipf_s=%s needs n_templates >= 1 (the "
            "query-template pool the skew is drawn over)", zipf_s,
        )
        w = zipf_template_weights(n_templates, zipf_s)
        tmpl = rng.choice(np.arange(n_templates, dtype=np.int64),
                          size=n_requests, p=w)
    return ArrivalSchedule(times_s=times, sizes=sz, template_ids=tmpl)


def replay(schedule: ArrivalSchedule,
           submit: Callable[[int, int], object], *,
           clock: Callable[[], float] = time.monotonic,
           sleep: Callable[[float], None] = time.sleep,
           ) -> Tuple[List[object], np.ndarray, float]:
    """Drive ``submit(i, size)`` open-loop against the wall clock.

    Each call fires at its scheduled offset from the replay start; the
    loop NEVER waits on what ``submit`` returned (completions are the
    server's problem — that is the open loop). If the previous submit
    call itself ran long, the next one fires immediately — offered
    load is the schedule's, not the server's, and ``max_lag_s``
    reports how far the generator fell behind (a lag comparable to the
    inter-arrival gap means the measured rate is submit-bound, not
    schedule-bound).

    Returns ``(results, t_submit, max_lag_s)``: per-request submit
    return values (futures, or the exception instance when ``submit``
    raised — an admission shed is DATA in an open-loop run, not a
    failure), per-request actual submit stamps on ``clock``, and the
    worst scheduling lag.
    """
    results: List[object] = []
    stamps = np.zeros(schedule.n_requests, np.float64)
    max_lag = 0.0
    t0 = clock()
    for i in range(schedule.n_requests):
        target = t0 + float(schedule.times_s[i])
        now = clock()
        if now < target:
            sleep(target - now)
            now = clock()
        max_lag = max(max_lag, now - target)
        stamps[i] = now
        try:
            results.append(submit(i, int(schedule.sizes[i])))
        except Exception as exc:   # noqa: BLE001 — sheds are data here
            results.append(exc)
    return results, stamps, max_lag
