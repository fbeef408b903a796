"""Attention-kernel launches per device batch over the window, from the
port's exact launch counters (``ops/launches.py``, graph replays included):
the block evaluations that the CFG cutoff and the block cache leave."""

ATTENTION = ("vmem_attention_nhd", "vmem_attention_nhd_pack", "vmem_attention",
             "splash_attention")


def read(run):
    batches = len(run.window.spans)
    if not batches:
        return None
    n = sum(run.window.launches.get(k, 0) for k in ATTENTION)
    return n / batches if n else None
