"""search.sync_idle_ms: device idle ms per captured search call, in the
gaps between device activity that one of the program's ``ivf.sync``
ranges (a device-to-host read inside the search) overlaps."""

from benchmark import program_spans


def read(run):
    return program_spans.per_call_ms(run, "sync_idle_us")
