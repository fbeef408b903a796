"""Mean wall of a device batch over the window: the benchmark's span around
each call into the entry (``synthesize_requests`` under the engine,
``synthesize_chunks`` alone), host prep, sampler, vocoder and copy to host."""


def read(run):
    spans = run.window.spans
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / len(spans) if spans else None
