"""Mean card time per call of the profiled slice of the sampler in a cell
whose backbone attends through K5 (the UNetT): the union of the device
intervals of the operations launched inside the program's ``synth.sample``
span. Each call's span must hold the K5 calls its batch makes, under the
roofline's rule for records the profiler dropped
(``readings.MIN_CALLS_FOUND``); else None, as where the backbone runs no K5."""

import sys

from portbench import roofline, spans
from portbench.readings import MIN_CALLS_FOUND, model_of

KERNEL = "K5"


def read(run):
    per_call = spans.stage_ops(run, "synth.sample")
    if per_call is None:
        return None
    backbone, config = model_of(run)
    found = []
    for call, ops in per_call:
        want = roofline.batch_bounds(backbone, config, run.traffic["sampler"],
                                     run.traffic.get("quant"), call.n, call.durations)
        want = want.get(KERNEL, [0])[0]
        calls = sum(1 for o in ops if roofline.kernel_of(o.name) == KERNEL)
        if not want or calls > want or calls < MIN_CALLS_FOUND * want:
            print(f"[portbench] synth.sample holds {calls} {KERNEL} calls of the {want} its "
                  "batch makes", file=sys.stderr, flush=True)
            return None
        found.append(f"{calls}/{want}")
    card = [spans.card_us(ops) / 1e3 for _, ops in per_call]
    print(f"[portbench] {KERNEL} calls in each synth.sample: {' '.join(found)}; card ms: "
          + " ".join(f"{c:.3f}" for c in card), file=sys.stderr, flush=True)
    return sum(card) / len(card)
