"""chunk_mins_roofline: the least time of the captured phase-1 launches
(``roofline_knn.chunk_mins_least_s`` on each launch's inputs) over the
device time of the kernels in the program's ``knn.chunk_mins`` ranges."""

from benchmark import knn_spans, roofline_knn


def read(run):
    return knn_spans.roofline_pct(run, "knn.chunk_mins", "bench.chunk_mins",
                                  roofline_knn.chunk_mins_least_s)
