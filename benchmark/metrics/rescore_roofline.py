"""rescore_roofline: the least time of the captured rescore launches
(``roofline_knn.rescore_least_s`` on each launch's inputs, f32 rate) over
the device time of the kernels in the program's ``knn.rescore`` ranges."""

from benchmark import knn_spans, roofline_knn


def read(run):
    return knn_spans.roofline_pct(run, "knn.rescore", "bench.rescore",
                                  roofline_knn.rescore_least_s)
