"""Launches of the conv position embedding's kernel per device batch over
the window, from the port's exact launch counters (``ops/launches.py``,
graph replays included): two a DiT forward, so 2 x NFE a batch. None from
a program without the kernel's counter."""

CONV = "conv_taps_mish"


def read(run):
    batches = len(run.window.spans)
    if not batches:
        return None
    n = run.window.launches.get(CONV, 0)
    return n / batches if n else None
