"""beam_scan_roofline: the least time of the captured beam-kernel launches
(``roofline_graph.beam_scan_least_s`` on each kept launch's ids) over the
device time of the harness spans around those same launches."""

from benchmark import graph_spans


def read(run):
    return graph_spans.beam_scan_roofline_pct(run)
