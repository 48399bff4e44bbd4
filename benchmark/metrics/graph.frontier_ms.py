"""graph.frontier_ms: device ms per captured graph search of the kernels
launched inside the program's ``graph.frontier`` ranges: the frontier's selection, the neighbour gather, the within-round dedup sort, and the visited filter and mark."""

from benchmark import graph_spans


def read(run):
    return graph_spans.per_call_ms(run, "phase_us", "graph.frontier")
