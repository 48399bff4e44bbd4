"""search.dropped_pairs_pct: the share of (query, probe) pairs that the
grouped search dropped past ``qcap`` over the captured calls (the
program's ``ivf_search_pairs_dropped_total`` over
``ivf_search_pairs_total`` for the cell's engine, counted while its
ranges are emitted)."""

from benchmark import program_spans


def read(run):
    return program_spans.dropped_pairs_pct(run)
