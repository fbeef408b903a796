"""Launches of K5 (``ops/attention.py:vmem_attention``) per device batch over
the window, from the port's exact launch counters (``ops/launches.py``,
graph replays included): one a block evaluation, so depth x NFE a batch
without the block cache. None where the window launched none."""

K5 = "vmem_attention"


def read(run):
    batches = len(run.window.spans)
    if not batches:
        return None
    n = run.window.launches.get(K5, 0)
    return n / batches if n else None
