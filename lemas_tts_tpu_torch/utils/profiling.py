"""Stage timers (spans on a ``torch.profiler`` trace while one records),
structured JSON-lines logging and the per-request trace schema of the
serving engine (counterpart of ``lemas_tts_tpu/utils/profiling.py``, without
its ``jax.profiler`` capture: the port traces the card with
``torch.profiler``), and the card's timing:
``device_ms`` (CUDA events around calls queued behind a spin),
``profile_card`` (busy time as the union of kernel intervals, idle share)
and ``summarize_trace`` (a saved Chrome trace)."""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional


def _profiler_on() -> bool:
    """Whether a ``torch.profiler`` session is recording in this process (no
    session can be while torch is not imported)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class StageTimers:
    """Named wall-clock timers with count/total/max aggregation. A stage is
    also a span: while a ``torch.profiler`` session records, it opens a
    ``record_function`` range of its name (with ``args``, e.g. the ids of
    the requests it serves), which the trace shows on the host timeline, on
    the clock of the card's kernels, nested in the stage around it. With no
    session, the cost is one flag check and the timer update."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0, "total_s": 0.0, "max_s": 0.0})

    @contextlib.contextmanager
    def stage(self, name: str, args: Optional[str] = None) -> Iterator[None]:
        span = None
        if _profiler_on():
            from torch.profiler import record_function

            span = record_function(name, args)
            span.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if span is not None:
                span.__exit__(None, None, None)
            with self._lock:
                s = self._stats[name]
                s["count"] += 1
                s["total_s"] += dt
                s["max_s"] = max(s["max_s"], dt)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: {**v, "mean_s": v["total_s"] / max(1, v["count"])}
                    for k, v in self._stats.items()}


TIMERS = StageTimers()  # process-global default

# One ``request_trace`` record per request that the engine completes, and one
# ``stream_trace`` per /tts_stream, when tracing is on
# (``ServingEngine(trace_requests=True)``, ``serve_http --trace_requests`` or
# ``LEMAS_REQUEST_TRACE=1``): the fields say where a request's time went.
REQUEST_TRACE_FIELDS = {
    "rid": "engine request id",
    "bucket": "composite batch key (cfg_id * stride + duration bucket)",
    "dur_bucket": "duration bucket (frames)",
    "batch_size": "rows in the dispatched batch this request rode in",
    "queue_wait_ms": "submit → batch collection",
    "batch_ms": "wall of the batch's synthesize_requests call on the engine's worker thread "
                "(host prep, sampler, vocoder, copy to host; shared by all rows of the batch)",
    "total_ms": "submit → result set",
    "outcome": "ok | error | shed_timeout | shed_cancelled",
}
STREAM_TRACE_FIELDS = {
    "ttfb_ms": "request start → first audio chunk written",
    "n_chunks": "text chunks synthesized",
    "total_ms": "request start → stream complete",
    "chunk_batch": "steady-state mini-batch size",
    "outcome": "ok | aborted",
}


def trace_record(logger: "JsonLogger", event: str, **fields: Any) -> None:
    """Emit a trace record; a field outside the schema raises."""
    schema = REQUEST_TRACE_FIELDS if event == "request_trace" else STREAM_TRACE_FIELDS
    unknown = set(fields) - set(schema)
    if unknown:
        raise ValueError(f"unknown trace fields {unknown} for {event}")
    logger.log(event, **fields)


class JsonLogger:
    """Structured JSON-lines event logger (metrics, serving events)."""

    def __init__(self, stream=None, path: Optional[str] = None):
        self._lock = threading.Lock()
        self._fh = open(path, "a", encoding="utf-8") if path else (stream or sys.stderr)

    def log(self, event: str, **fields: Any) -> None:
        line = json.dumps({"ts": time.time(), "event": event, **fields}, default=str)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()


# ------------------------------------------------------------ card timing


def device_ms(fns, iters: int = 20) -> float:
    """Card time per call over ``iters`` calls cycling through ``fns``, after
    one warm-up round: the card first spins for ~10 ms (``torch.cuda._sleep``)
    while the host queues the events and the calls behind it, so the events
    time the calls back to back on the card and leave out the host's issue
    time, which back-to-back host timing of a ~40 us kernel counts."""
    import torch

    for f in fns:
        f()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # clock cycles
    a.record()
    for i in range(iters):
        fns[i % len(fns)]()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def interval_union(spans) -> float:
    """Total length covered by ``(start, end)`` intervals: the card's busy
    time from its kernels' intervals (a graph's kernels may overlap, so their
    summed time overstates it)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_card(fn, trace_path: Optional[str] = None) -> Dict[str, Any]:
    """``fn()`` once under ``torch.profiler`` (CPU and CUDA activities), the
    call ending in a sync: wall ms, the card's busy ms (``interval_union`` of
    its kernel intervals), the kernels' summed ms, their count, the idle
    share of the wall, the number of intervals and ``rows`` ``[(us, count,
    name)]`` of card time by kernel, largest first. ``trace_path`` keeps the
    Chrome trace (``summarize_trace`` reads it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == cuda and getattr(e, "self_device_time_total", 0) > 0),
                  reverse=True)
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == cuda and e.time_range.end > e.time_range.start]
    busy = interval_union(spans)
    if trace_path:
        prof.export_chrome_trace(trace_path)
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "summed_ms": sum(r[0] for r in rows) / 1e3, "kernels": sum(r[1] for r in rows),
            "idle": 1 - busy / wall_us, "intervals": len(spans), "rows": rows}


def summarize_trace(path: str, top: int = 25) -> str:
    """Tabulate a Chrome trace that ``torch.profiler`` wrote: per event
    category, the card's kernels (``kernel``, with their busy union) or, in
    a trace with none (a CPU run), the host's operators (``cpu_op``), the
    ``top`` names by total time."""
    import collections

    with open(path, encoding="utf-8") as fh:
        events = json.load(fh).get("traceEvents", [])
    out = []
    for cat in ("kernel", "cpu_op"):
        evs = [e for e in events if e.get("cat") == cat and e.get("ph") == "X"]
        if not evs:
            continue
        tot: collections.Counter = collections.Counter()
        cnt: collections.Counter = collections.Counter()
        for e in evs:
            tot[e["name"]] += float(e.get("dur", 0.0)) / 1e3
            cnt[e["name"]] += 1
        head = f"== {cat}: {len(evs)} events, summed {sum(tot.values()):.3f} ms"
        if cat == "kernel":
            spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in evs]
            head += f", card busy {interval_union(spans) / 1e3:.3f} ms (union)"
        out.append(head)
        for name, ms in tot.most_common(top):
            out.append(f"{ms:9.3f} ms  n={cnt[name]:>5}  {name[:110]}")
        if cat == "kernel":
            break  # a card trace: its host operators are not the time
    return "\n".join(out) or "(no kernel or operator events in the trace)"
