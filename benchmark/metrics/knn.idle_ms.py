"""knn.idle_ms: device idle ms per captured brute-force call, in the gaps
between device activity whose midpoint lies inside the program's
``knn.search`` range."""

from benchmark import knn_spans


def read(run):
    return knn_spans.per_call_ms(run, "idle_us")
