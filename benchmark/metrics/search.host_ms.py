"""search.host_ms: host milliseconds to issue one batch call (the call
returns before the device is done, unless the program waits inside it),
the mean over the window's calls before the profiler capture."""


def read(run):
    durs = run.trace.host_durations("bench.search", run.window.t0)
    return 1e3 * sum(durs) / len(durs) if durs else None
