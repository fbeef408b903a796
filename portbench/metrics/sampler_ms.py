"""Mean card time per call of the profiled slice of the sampler: the union of
the device intervals of the operations launched inside the program's
``synth.sample`` span (the graph's copy-in and replay). Each call's span must
hold the K1-K3 calls its batch makes, under the roofline's rule for records
the profiler dropped (``readings.MIN_CALLS_FOUND``); else None."""

import sys

from portbench import roofline, spans
from portbench.readings import MIN_CALLS_FOUND, model_of

KERNELS = ("K1", "K2", "K3")


def read(run):
    per_call = spans.stage_ops(run, "synth.sample")
    if per_call is None:
        return None
    backbone, config = model_of(run)
    found = {k: [] for k in KERNELS}
    for call, ops in per_call:
        want = roofline.batch_bounds(backbone, config, run.traffic["sampler"],
                                     run.traffic.get("quant"), call.n, call.durations)
        for k in KERNELS:
            if k not in want:
                continue
            calls = sum(1 for o in ops if roofline.kernel_of(o.name) == k
                        and roofline.is_call(k, o.name))
            found[k].append(f"{calls}/{want[k][0]}")
            if calls > want[k][0] or calls < MIN_CALLS_FOUND * want[k][0]:
                print(f"[portbench] synth.sample holds {calls} {k} calls of the {want[k][0]} "
                      "its batch makes", file=sys.stderr, flush=True)
                return None
    card = [spans.card_us(ops) / 1e3 for _, ops in per_call]
    reach = [(max(o.t1 for o in ops) - min(o.t0 for o in ops)) / 1e3 if ops else 0.0
             for _, ops in per_call]
    print("[portbench] calls in each synth.sample: " + "; ".join(
        f"{k} {' '.join(v)}" for k, v in found.items() if v) + "; card ms (first start to "
        "last end): " + " ".join(f"{c:.3f} ({r:.3f})" for c, r in zip(card, reach)),
        file=sys.stderr, flush=True)
    return sum(card) / len(card)
