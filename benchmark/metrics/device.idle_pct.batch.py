"""device.idle_pct.batch: the share of the capture's window in which no
operation ran on the device (the window less the union of the device's
activity intervals)."""

from benchmark.tracing import idle_pct


def read(run):
    return idle_pct(run.capture)
