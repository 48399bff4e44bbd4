"""graph.scan_ms: device ms per captured graph search of the kernels
launched inside the program's ``graph.scan`` ranges: the beam kernel (#5), its sub-chunk selection and gathers (on the exact engine, score_l2_candidates)."""

from benchmark import graph_spans


def read(run):
    return graph_spans.per_call_ms(run, "phase_us", "graph.scan")
