"""knn.select_ms: device ms per captured brute-force call of the kernels
launched inside the program's ``knn.select`` ranges: the stable sorts
(``top_k_smallest``) over the chunk minima and over the rescored
candidates, with their index arithmetic."""

from benchmark import knn_spans


def read(run):
    return knn_spans.per_call_ms(run, "phase_us", "knn.select")
