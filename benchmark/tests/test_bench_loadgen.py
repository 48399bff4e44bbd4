"""The closed loop measures over all the work of its window: it ends with
the last answer of a call started inside the window, and no call starts
after it."""

from __future__ import annotations

from benchmark import loadgen


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_ends_with_the_last_answer_of_a_call_started_in_it():
    clock = FakeClock()
    calls = []

    def call():
        calls.append(clock.t)
        clock.t += 0.3                 # each call answers 300 ms after it starts
        return len(calls)

    w = loadgen.closed_loop(call, 1.0, clock=clock)
    # calls start at 0, 0.3, 0.6 and 0.9 s; the last answers at 1.2 s
    assert w.answers == [1, 2, 3, 4]
    assert w.t0 == 100.0 and abs(w.t_end - 101.2) < 1e-9
    assert all(t - w.t0 < 1.0 for t in calls)
