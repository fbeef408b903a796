"""What the per-layer metric readers share: the profiled slice's FLOPs at
the chip's peaks (the backbone family's count), and a kernel's roofline
share in the slice (K1-K6 from ``roofline.py``, another kernel from its file
in ``portbench/kernels/``). Every reader returns None where its run holds
nothing for it to read. A reader that takes a kernel's share names the
kernels in its ``KERNELS``, so that a kernel without its file stops the run
at set-up."""

from __future__ import annotations

import sys
from typing import Optional

from portbench import flops, roofline
from portbench import trace as tracing

MIN_CALLS_FOUND = 0.95  # share of a kernel's calls that a trace must hold


def model_of(run) -> tuple:
    """``(backbone family, configuration)`` of a run. A run that carries no
    family but the DiT's ``arch`` alone, as ``tests/test_torch_spans.py``
    lays one out by hand, is a DiT's."""
    if hasattr(run, "backbone"):
        return run.backbone, run.config
    from portbench.backbones import dit

    return dit, {"model": {"arch": run.arch}}


def slice_flops_seconds(run) -> Optional[float]:
    """Seconds at the chip's peaks for the sampler calls of the slice."""
    if run.profile is None or not run.window.slice.spans:
        return None
    backbone, config = model_of(run)
    return sum(flops.peak_seconds(backbone.sampler_call_flops(
        config, run.traffic["sampler"], len(s.durations), s.n, run.traffic.get("quant")))
        for s in run.window.slice.spans)


def roofline_share(run, kernels) -> Optional[float]:
    """Seconds at the roofline over card seconds of ``kernels`` in the slice,
    in %: each call that the trace holds at the mean bound of a call of its
    kernel in the slice's batches, over the union of the intervals in which
    the trace shows that kernel on the card. The profiler drops a few records
    (whole block evaluations, all kernels alike); None where the trace holds
    more calls of a kernel than the batches make (other work) or under
    ``MIN_CALLS_FOUND`` of them."""
    if run.profile is None or not run.window.slice.spans:
        return None
    files = {k: run.kernel(k) for k in kernels if k not in roofline.SYMBOLS}
    backbone, config = model_of(run)
    expected = {}
    for s in run.window.slice.spans:
        for k, (calls, secs) in roofline.batch_bounds(backbone, config, run.traffic["sampler"],
                                                      run.traffic.get("quant"), s.n,
                                                      s.durations, files).items():
            e = expected.setdefault(k, [0, 0.0])
            e[0] += calls
            e[1] += secs
    bound = card = 0.0
    for k in kernels:
        ops = [(name, t, d) for name, t, d in run.profile.device_ops
               if roofline.is_launch(k, name, files.get(k))]
        calls = sum(1 for name, _, _ in ops if roofline.is_call(k, name, files.get(k)))
        want, secs = expected.get(k, [0, 0.0])
        print(f"[portbench] {k}: the trace holds {calls} calls of the {want} that the "
              f"slice's batches make", file=sys.stderr, flush=True)
        if calls > want or calls < MIN_CALLS_FOUND * want:
            return None
        if not calls:
            continue
        bound += secs / want * calls
        card += tracing.union_us([(t, t + d) for _, t, d in ops]) / 1e6
    return 100.0 * bound / card if card > 0 else None
