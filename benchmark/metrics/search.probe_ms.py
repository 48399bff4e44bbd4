"""search.probe_ms: device ms per captured search call of the kernels
launched inside the program's ``ivf.probe`` ranges, less those of
program ranges nested in them: the coarse probe (gram and sort), or the
eager probe of an auto-sized qcap."""

from benchmark import program_spans


def read(run):
    return program_spans.per_call_ms(run, "phase_us", "ivf.probe")
