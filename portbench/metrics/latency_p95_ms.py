"""95th percentile of every request's latency, from when its client issued
it to when its wave was on the host (host clock; a failed request counts as
the mix's timeout)."""

from portbench.drive import rate_and_tail


def read(run):
    return rate_and_tail(run.window, float(run.traffic["request_timeout_s"]))[1]
