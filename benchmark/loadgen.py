"""Traffic: the closed loop that drives a batch cell's window.

One caller sends a call, waits for its answer on the host, and sends the
next, until the window's seconds have passed. Every seed does the same
work: the run's seed only orders the queries (``data.py``).
"""

from __future__ import annotations

import time


class Window:
    """What the loop measured: each call's answer, and the window's start
    and end on the host clock."""

    def __init__(self):
        self.answers: list = []
        self.t0 = 0.0
        self.t_end = 0.0


def closed_loop(call, seconds: float, *, clock=time.perf_counter) -> Window:
    """One caller: ``call()`` returns its answer on the host, then the
    next call starts, until ``seconds`` have passed since the first. The
    window ends with the last answer of a call started in it."""
    w = Window()
    w.t0 = t = clock()
    while t - w.t0 < seconds:
        w.answers.append(call())
        t = clock()
    w.t_end = t
    return w
