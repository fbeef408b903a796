"""Mean host wall of the program's ``synth.prep`` span in the profiled slice:
the reference's RMS, resample and mel (with its copy to the host), the text
ids, the host arrays and their uploads, up to the sampler call."""

from portbench import spans


def read(run):
    trace = spans.of(run)
    preps = trace.named("synth.prep") if trace is not None else []
    return sum(s.t1 - s.t0 for s in preps) / len(preps) / 1e3 if preps else None
