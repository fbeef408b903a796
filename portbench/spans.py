"""The program's own spans in the profiled slice, and the device operations
each span launched: what the per-stage readers share.

The port opens a ``record_function`` range for each stage of a request
(``utils/profiling.py:StageTimers.stage``) while a profiler records:
``synth.request`` around a call, inside it ``synth.prep``, ``synth.sample``,
``synth.vocode``, ``synth.fetch`` and ``synth.finish``, and ``graph.capture``
around a sampler graph's capture. The profiler keeps each range on the host
timeline, on the clock of the device's operations, and each device operation
with the correlation id of the call that launched it (a kernel of a replayed
graph: that of its ``cudaGraphLaunch``). So a device operation belongs to
the spans open on the launching thread at its launch.

Read once a run from the slice's profiler (its Chrome trace is already
written, so from the profiler's own events) and kept on the run; a program
without the spans (before they were added) gives none, and every reader then
returns None.
"""

from __future__ import annotations

import bisect
import statistics
import sys
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from portbench import trace as tracing

PROGRAM = ("synth.", "graph.", "serve.")  # the prefixes of the program's span names
OUTSIDE = "outside the program's spans"


@dataclass
class Span:
    name: str
    t0: float  # us, the profiler's clock
    t1: float
    thread: int


@dataclass
class Op:
    name: str
    t0: float  # us on the device
    t1: float
    launch: Optional[float] = None  # us on the host, None where the trace lost the launch
    thread: int = -1


@dataclass
class Trace:
    spans: List[Span]
    ops: List[Op]
    _merged: Optional[List[List[float]]] = field(default=None, repr=False)
    _by_launch: Optional[list] = field(default=None, repr=False)

    def named(self, name: str) -> List[Span]:
        return sorted((s for s in self.spans if s.name == name), key=lambda s: s.t0)

    def launched_in(self, span: Span) -> List[Op]:
        """The device operations launched on ``span``'s thread inside it."""
        if self._by_launch is None:
            launched = sorted((o for o in self.ops if o.launch is not None),
                              key=lambda o: o.launch)
            self._by_launch = ([o.launch for o in launched], launched)
        at, launched = self._by_launch
        lo, hi = bisect.bisect_left(at, span.t0), bisect.bisect_right(at, span.t1)
        return [o for o in launched[lo:hi] if o.thread == span.thread]

    def merged(self) -> List[List[float]]:
        """The device's busy intervals, merged, in order."""
        if self._merged is None:
            out: List[List[float]] = []
            for a, b in sorted((o.t0, o.t1) for o in self.ops):
                if out and a <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], b)
                else:
                    out.append([a, b])
            self._merged = out
        return self._merged

    def busy_in(self, t0: float, t1: float) -> float:
        """us of ``[t0, t1]`` in which some device operation ran."""
        return sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in self.merged()
                   if a < t1 and b > t0)


def card_us(ops: List[Op]) -> float:
    """us in which at least one of ``ops`` ran on the device."""
    return tracing.union_us([(o.t0, o.t1) for o in ops])


def from_profiler(prof) -> Trace:
    """The program's spans and the device operations from a stopped
    ``torch.profiler.profile``, each operation with the host time and thread
    of the runtime call whose correlation id it carries."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, dev, launches = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_device = e.device_type() == cuda
        if e.is_user_annotation():
            if not on_device and name.startswith(PROGRAM):
                spans.append(Span(name, e.start_ns() / 1e3, e.end_ns() / 1e3,
                                  e.start_thread_id()))
        elif on_device:
            dev.append((name, e.start_ns() / 1e3, e.end_ns() / 1e3, e.correlation_id()))
        elif name.startswith("cu"):  # a CUDA API call: cudaLaunchKernel, cuLaunchKernel, a copy
            launches[e.correlation_id()] = (e.start_ns() / 1e3, e.start_thread_id())
    ops = []
    for name, a, b, corr in dev:
        at, thread = launches.get(corr, (None, -1))
        ops.append(Op(name, a, b, at, thread))
    return Trace(spans, ops)


def of(run) -> Optional[Trace]:
    """The run's trace of program spans (read once, kept on ``run``), None
    where the run was not traced or the program opened no span."""
    if not hasattr(run, "program_trace"):
        sl = run.window.slice
        trace = from_profiler(sl.prof) if run.profile is not None and sl.prof is not None \
            else None
        run.program_trace = trace if trace is not None and trace.spans else None
    return run.program_trace


def requests(run) -> Optional[List[Tuple[Span, object]]]:
    """Each ``synth.request`` of the slice with the benchmark's own span of
    the same call (``drive.Span``: its rows, bucket and durations), in order;
    None where their numbers differ."""
    trace = of(run)
    if trace is None:
        return None
    reqs, calls = trace.named("synth.request"), run.window.slice.spans
    if not reqs or len(reqs) != len(calls):
        print(f"[portbench] the trace holds {len(reqs)} synth.request spans for the slice's "
              f"{len(calls)} calls", file=sys.stderr, flush=True)
        return None
    return list(zip(reqs, calls))


def slice_bounds(run) -> Optional[Tuple[float, float]]:
    """The slice's wall (profiler start to stop, host clock) on the
    profiler's clock: moved by the median offset between each call's
    ``synth.request`` and the benchmark's span of it, which open a few us
    apart."""
    pairs = requests(run)
    if pairs is None:
        return None
    offset = statistics.median(r.t0 - 1e6 * c.t0 for r, c in pairs)
    sl = run.window.slice
    return 1e6 * sl.t0 + offset, 1e6 * sl.t1 + offset


def innermost(spans: List[Span]):
    """``label(t)``: the name of the shortest span holding ``t``, or
    ``OUTSIDE``."""
    edges = sorted({s.t0 for s in spans} | {s.t1 for s in spans})
    labels = []
    for a, b in zip(edges, edges[1:]):
        mid = 0.5 * (a + b)
        inside = [s for s in spans if s.t0 <= mid <= s.t1]
        labels.append(min(inside, key=lambda s: s.t1 - s.t0).name if inside else OUTSIDE)

    def label(t: float) -> str:
        i = bisect.bisect_right(edges, t) - 1
        return labels[i] if 0 <= i < len(labels) else OUTSIDE

    return label


def idle_split(run) -> Optional[Dict[str, float]]:
    """Seconds of the slice's wall in which no device operation ran, summed
    by the innermost program span running on the host at each gap's middle
    (``OUTSIDE`` where none), as ``trace.breakdown`` sums them by operator."""
    trace, bounds = of(run), slice_bounds(run)
    if bounds is None or not trace.ops:
        return None
    w0, w1 = bounds
    label = innermost(trace.spans)
    split: Counter = Counter()
    end = w0
    for a, b in trace.merged() + [[w1, w1]]:
        a = min(max(a, w0), w1)
        if a > end:
            split[label(0.5 * (end + a))] += (a - end) / 1e6
        end = max(end, min(b, w1))
    return dict(split)


def stage_ops(run, stage: str) -> Optional[List[Tuple[object, List[Op]]]]:
    """For each call of the slice, the benchmark's span of it and the device
    operations launched inside its ``stage`` span; None where the trace holds
    no device operation or a call not exactly one such span."""
    pairs, trace = requests(run), of(run)
    if pairs is None or not trace.ops:
        return None
    stages = trace.named(stage)
    out = []
    for req, call in pairs:
        inside = [s for s in stages
                  if s.thread == req.thread and req.t0 <= s.t0 and s.t1 <= req.t1]
        if len(inside) != 1:
            print(f"[portbench] a synth.request holds {len(inside)} {stage} spans",
                  file=sys.stderr, flush=True)
            return None
        out.append((call, trace.launched_in(inside[0])))
    return out
