"""knn.chunk_mins_ms: device ms per captured brute-force call of the
kernels launched inside the program's ``knn.chunk_mins`` ranges: phase 1
(#6, the bf16 chunk minima), and the rows' norms where a call takes them."""

from benchmark import knn_spans


def read(run):
    return knn_spans.per_call_ms(run, "phase_us", "knn.chunk_mins")
