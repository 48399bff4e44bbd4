"""build_s: the index build's wall time, from the rows resident on the
device to a searchable index, the device synchronised on both sides."""


def read(run):
    return run.build_s
