"""Mean card time per call of the profiled slice of the vocoder: the union of
the device intervals of the operations launched inside the program's
``synth.vocode`` span (the slice for the vocoder and ``Vocos.decode``)."""

from portbench import spans


def read(run):
    per_call = spans.stage_ops(run, "synth.vocode")
    if per_call is None:
        return None
    return sum(spans.card_us(ops) for _, ops in per_call) / len(per_call) / 1e3
