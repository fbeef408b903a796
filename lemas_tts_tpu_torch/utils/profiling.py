"""Stage timers, structured JSON-lines logging and the per-request trace
schema of the serving engine (counterpart of
``lemas_tts_tpu/utils/profiling.py``, without its ``jax.profiler`` capture:
the port traces the card with ``torch.profiler``)."""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional


class StageTimers:
    """Named wall-clock timers with count/total/max aggregation."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0, "total_s": 0.0, "max_s": 0.0})

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
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
    "device_ms": "batch wall on the device thread (shared by all rows of the batch)",
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
