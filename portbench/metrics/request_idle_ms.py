"""Mean time per call of the profiled slice in which the device ran nothing
while the program's ``synth.request`` span was open: the span's wall less
the union of the device intervals inside it.

Prints to standard error the slice's whole idle time split by the innermost
program span running on the host at each gap's middle, the part outside any
``synth.request``, and their sum against the slice's ``device_idle_share``."""

import sys

from portbench import spans


def read(run):
    pairs, trace = spans.requests(run), spans.of(run)
    if pairs is None or not trace.ops:
        return None
    idle = [(r.t1 - r.t0) - trace.busy_in(r.t0, r.t1) for r, _ in pairs]
    split = spans.idle_split(run)
    if split:
        wall = run.profile.window_s
        total = sum(split.values())
        parts = ", ".join(f"{k} {v:.6f} s" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
        print(f"[portbench] idle by program span: {parts}; outside synth.request "
              f"{total - sum(idle) / 1e6:.6f} s; sum {total:.6f} s = {100 * total / wall:.3f} % "
              f"of the slice's {wall:.6f} s wall (device_idle_share "
              f"{100 * (1 - run.profile.busy_s / wall):.3f} %)", file=sys.stderr, flush=True)
    return sum(idle) / len(idle) / 1e3
