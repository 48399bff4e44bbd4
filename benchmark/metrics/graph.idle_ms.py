"""graph.idle_ms: device idle ms per captured graph search, in the gaps
between device activity whose midpoint lies inside the program's
``graph.search`` range."""

from benchmark import graph_spans


def read(run):
    return graph_spans.per_call_ms(run, "idle_us")
