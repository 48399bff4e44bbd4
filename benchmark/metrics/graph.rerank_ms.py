"""graph.rerank_ms: device ms per captured graph search of the kernels
launched inside the program's ``graph.rerank`` ranges: the exact tail and its top-k."""

from benchmark import graph_spans


def read(run):
    return graph_spans.per_call_ms(run, "phase_us", "graph.rerank")
