"""search.invert_ms: device ms per captured search call of the kernels
launched inside the program's ``ivf.invert`` ranges, less those of
program ranges nested in them: the probe map's inversion
(invert_probe_map_ranked: two stable argsorts and the scatter)."""

from benchmark import program_spans


def read(run):
    return program_spans.per_call_ms(run, "phase_us", "ivf.invert")
