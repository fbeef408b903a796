"""Seconds of audio of the requests finished inside the window, per second
of the window (host clock)."""

from portbench.drive import rate_and_tail


def read(run):
    return rate_and_tail(run.window, float(run.traffic["request_timeout_s"]))[0]
