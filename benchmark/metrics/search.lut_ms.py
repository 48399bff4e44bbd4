"""search.lut_ms: device ms per captured search call of the kernels
launched inside the program's ``ivf.lut`` ranges, less those of program
ranges nested in them: IVF-PQ's ADC table builds (one a LUT chunk)."""

from benchmark import program_spans


def read(run):
    return program_spans.per_call_ms(run, "phase_us", "ivf.lut")
