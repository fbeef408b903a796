"""K5 (``ops/attention.py:vmem_attention``, ``csrc/attention_bhnd.cu``) in
the profiled slice: its calls' time at the roofline over its card time, in %
(symbol and arithmetic in ``portbench/roofline.py``, which counts a call at
the bucket's N and its valid frames; the UNetT runs N + 1 with the time token
valid, so the bound reads ~0.2 % low there)."""

from portbench.readings import roofline_share

KERNELS = ("K5",)


def read(run):
    return roofline_share(run, KERNELS)
