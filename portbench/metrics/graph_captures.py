"""Sampler graphs captured inside the measured window (host clock, from its
start for ``--seconds``), from the program's capture counter
(``cfm/graph.py:CAPTURES``): each is a stall of its request for an eager
sampler run and the capture. None from a program without the counter."""


def read(run):
    from lemas_tts_tpu_torch.cfm import graph

    captures = getattr(graph, "CAPTURES", None)
    if captures is None:
        return None
    w = run.window
    return len(captures.since(w.t_start, w.t_start + w.seconds))
