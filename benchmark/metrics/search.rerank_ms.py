"""search.rerank_ms: device ms per captured search call of the kernels
launched inside the program's ``ivf.rerank`` ranges, less those of
program ranges nested in them: the exact f32 rescoring of the pool's
rows (gather, score, select)."""

from benchmark import program_spans


def read(run):
    return program_spans.per_call_ms(run, "phase_us", "ivf.rerank")
