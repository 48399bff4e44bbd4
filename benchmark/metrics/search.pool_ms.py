"""search.pool_ms: device ms per captured search call of the kernels
launched inside the program's ``ivf.pool`` ranges, less those of program
ranges nested in them: the top of the pool of sub-chunk minima
(subchunk_pool_rows), or the legacy engine's top-k over its partials."""

from benchmark import program_spans


def read(run):
    return program_spans.per_call_ms(run, "phase_us", "ivf.pool")
