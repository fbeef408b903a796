"""The port's hand-written kernels together (K1, K2, K3, K5) in the profiled
slice: their calls' time at the roofline over their card time, in %."""

from portbench.readings import roofline_share


def read(run):
    return roofline_share(run, ("K1", "K2", "K3", "K5"))
