"""graph.merge_ms: device ms per captured graph search of the kernels
launched inside the program's ``graph.merge`` ranges: each round's top-P of pool and candidates."""

from benchmark import graph_spans


def read(run):
    return graph_spans.per_call_ms(run, "phase_us", "graph.merge")
