"""knn.rescore_ms: device ms per captured brute-force call of the kernels
launched inside the program's ``knn.rescore`` ranges: the exact f32
rescore of the candidate chunks (#7 and the concatenation of its
launches, or the gather route's gather and ``bmm``)."""

from benchmark import knn_spans


def read(run):
    return knn_spans.per_call_ms(run, "phase_us", "knn.rescore")
