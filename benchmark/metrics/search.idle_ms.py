"""search.idle_ms: device idle ms per captured search call, in the gaps
between device activity whose midpoint lies inside the program's entry
range (``ivf_flat.search`` / ``ivf_pq.search``)."""

from benchmark import program_spans


def read(run):
    return program_spans.per_call_ms(run, "idle_us")
