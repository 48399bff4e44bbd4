"""qps: queries answered in the window over the window's whole time, from
its first call to the last answer of a call started in it."""


def read(run):
    return run.qps()
