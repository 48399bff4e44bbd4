"""search.host_syncs: the program's device-to-host reads per search call
(its ``ivf_search_host_syncs_total`` over ``ivf_search_calls_total`` for
the cell's engine)."""

from benchmark import program_spans


def read(run):
    return program_spans.host_syncs_per_call(run)
