"""K1 in the profiled slice: its calls' time at the roofline over its card
time, in % (symbols and arithmetic in ``portbench/roofline.py``)."""

from portbench.readings import roofline_share


def read(run):
    return roofline_share(run, ("K1",))
