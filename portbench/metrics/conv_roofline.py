"""The conv position embedding's kernel in the profiled slice: its calls'
time at the roofline over its card time, in % (symbol and arithmetic in
``portbench/kernels/conv_taps.py``)."""

from portbench.readings import roofline_share

KERNELS = ("conv_taps",)


def read(run):
    return roofline_share(run, KERNELS)
