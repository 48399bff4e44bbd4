"""search.scan_ms: device ms per captured search call of the kernels
launched inside the program's ``ivf.scan`` ranges, less those of program
ranges nested in them: the list scans (the flat or ADC kernel, or the
legacy block scan) and their regroup into the pool, LUT builds nested in
it excluded."""

from benchmark import program_spans


def read(run):
    return program_spans.per_call_ms(run, "phase_us", "ivf.scan")
