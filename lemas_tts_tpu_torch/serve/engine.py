"""Continuous-batching TTS serving engine (counterpart of
``lemas_tts_tpu/serve/engine.py``).

Request threads submit :class:`TTSRequest`s; the micro-batcher (the C++
queue of ``native/batcher.py``) groups concurrent requests by sampler settings and
duration bucket; one worker thread drives the card with
``Synthesizer.synthesize_requests`` (each row its own reference), which on
CUDA replays the bucket's sampler graph. The model and its graphs are built
once and reused.

Under multi-process serving (``serve/multihost.py``) the synthesizer is the
broadcasting proxy, and a follower's death ``poison``s the engine: queued
and running requests fail at once and new ones are refused (``degraded`` in
``stats()``, a 503 at the HTTP layer).
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from lemas_tts_tpu_torch.config import SamplerConfig
from lemas_tts_tpu_torch.native.batcher import Batcher
from lemas_tts_tpu_torch.utils.profiling import TIMERS, JsonLogger, trace_record

# composite bucket = cfg_id * _BUCKET_STRIDE + duration bucket; the stride
# exceeds the largest duration bucket (4096), so the two never collide
_BUCKET_STRIDE = 1 << 13
# cap on distinct per-request sampler settings over an engine's life (each
# keeps its captured graphs)
_MAX_CFG_IDS = 32


@dataclass
class TTSRequest:
    ref_wav: np.ndarray
    ref_sr: int
    ref_units: Any  # token list or str
    gen_units: Any
    seed: Optional[int] = None
    # per-request sampler settings (None: the engine's); a batch holds
    # requests of one settings only
    cfg: Optional[SamplerConfig] = None
    # seconds from submit: a request still queued past it is shed at dispatch
    # with TimeoutError on its future
    timeout: Optional[float] = None
    future: Future = field(default_factory=Future)
    _t_submit: float = field(default=0.0, repr=False)
    _rid: int = field(default=0, repr=False)
    _bucket: int = field(default=0, repr=False)
    _dur_bucket: int = field(default=0, repr=False)


class ServingEngine:
    """Long-lived engine: ``submit()`` from any thread, results via Future."""

    def __init__(self, synthesizer, cfg: SamplerConfig = SamplerConfig(), max_batch: int = 8,
                 max_wait_ms: float = 15.0, logger: Optional[JsonLogger] = None,
                 max_queue: int = 256, trace_requests: Optional[bool] = None):
        self.synth = synthesizer
        self.cfg = cfg
        self.max_queue = max_queue
        self.batcher = Batcher(max_batch=max_batch, max_wait_ms=max_wait_ms)
        self.log = logger or JsonLogger()
        self.trace_requests = (os.environ.get("LEMAS_REQUEST_TRACE") == "1"
                               if trace_requests is None else trace_requests)
        self._pending: Dict[int, TTSRequest] = {}
        self._lock = threading.Lock()
        # requests that never reached the device: client cancel or deadline
        self._shed = {"cancelled": 0, "timed_out": 0}
        self._cfg_ids: Dict[SamplerConfig, int] = {cfg: 0}
        self._latencies: Dict[str, deque] = {}
        self._batch_sizes: deque = deque(maxlen=512)
        self._poisoned: Optional[BaseException] = None
        self._inflight: list = []  # the batch on the device, for poison()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ client API
    def register_cfg(self, cfg: SamplerConfig) -> int:
        """Settings id for the composite bucket, capped at ``_MAX_CFG_IDS``
        distinct settings (RuntimeError past it). Every path with
        per-request settings goes through here, streams included."""
        with self._lock:
            cfg_id = self._cfg_ids.get(cfg)
            if cfg_id is None:
                if len(self._cfg_ids) >= _MAX_CFG_IDS:
                    raise RuntimeError(f"too many distinct sampler settings ({_MAX_CFG_IDS}); "
                                       "reuse an existing combination")
                cfg_id = len(self._cfg_ids)
                self._cfg_ids[cfg] = cfg_id
        return cfg_id

    def _estimate_bucket(self, req: TTSRequest) -> "tuple[int, int]":
        """(composite bucket, duration bucket) of a request, from the
        synthesizer's own estimate, so a batch shares one graph."""
        cfg = req.cfg or self.cfg
        dur_bucket = self.synth.estimate_bucket(req.ref_wav, req.ref_sr, req.ref_units,
                                                req.gen_units, cfg)
        return self.register_cfg(cfg) * _BUCKET_STRIDE + dur_bucket, dur_bucket

    def submit(self, req: TTSRequest) -> Future:
        """Enqueue a request; the Future gives (wave, sr, mel). Raises
        RuntimeError when the engine is shut down, degraded or the queue is
        full."""
        if self._poisoned is not None:
            raise RuntimeError(f"engine degraded: {self._poisoned}")
        bucket, dur_bucket = self._estimate_bucket(req)
        req._t_submit = time.perf_counter()
        with self._lock:
            if self._poisoned is not None:
                raise RuntimeError(f"engine degraded: {self._poisoned}")
            if self.batcher.depth() >= self.max_queue:
                self.log.log("queue_full", depth=self.batcher.depth())
                raise RuntimeError(f"engine queue full ({self.max_queue} pending)")
            # cost in frames: the composite key must not leak into it
            rid = self.batcher.submit(bucket=bucket, cost=dur_bucket)
            if rid == 0:
                raise RuntimeError("engine is shut down")
            req._rid, req._bucket, req._dur_bucket = rid, bucket, dur_bucket
            self._pending[rid] = req
        return req.future

    def cancel(self, fut: Future) -> bool:
        """Cancel a submitted request (client gone). True if it will never
        produce a result: a queued request leaves the batcher at once; once
        its batch runs on the device, the Future cannot be cancelled."""
        with self._lock:
            req = next((r for r in self._pending.values() if r.future is fut), None)
            if req is None:
                return fut.cancel() or fut.cancelled()
            if self.batcher.cancel(req._rid):
                self._pending.pop(req._rid, None)
                self._shed["cancelled"] += 1
        cancelled = fut.cancel()
        if cancelled:
            self.log.log("request_cancelled", rid=req._rid)
        return cancelled

    def synthesize(self, ref_wav, ref_sr, ref_units, gen_units, seed=None,
                   timeout: Optional[float] = None):
        """Blocking convenience wrapper."""
        return self.submit(TTSRequest(ref_wav, ref_sr, ref_units, gen_units, seed)).result(
            timeout=timeout)

    # ------------------------------------------------------------ device loop
    def _loop(self):
        while not self._stop.is_set():
            ids, bucket = self.batcher.next_batch(timeout_ms=100)
            if not ids:
                continue
            with self._lock:
                reqs = [self._pending.pop(i) for i in ids if i in self._pending]
            # shed cancelled and expired requests before the batch is padded
            now = t_collect = time.perf_counter()
            live = []
            for r in reqs:
                if r.future.cancelled() or not r.future.set_running_or_notify_cancel():
                    with self._lock:
                        self._shed["cancelled"] += 1
                    self._trace(r, t_collect, 0.0, 0, "shed_cancelled")
                    continue
                if r.timeout is not None and r._t_submit and now - r._t_submit > r.timeout:
                    r.future.set_exception(TimeoutError(
                        f"request shed after {now - r._t_submit:.2f}s in queue "
                        f"(timeout={r.timeout}s)"))
                    with self._lock:
                        self._shed["timed_out"] += 1
                    self.log.log("request_timed_out", rid=r._rid,
                                 queued_s=round(now - r._t_submit, 3))
                    self._trace(r, t_collect, 0.0, 0, "shed_timeout")
                    continue
                live.append(r)
            reqs = live
            if not reqs:
                continue
            cfg = reqs[0].cfg or self.cfg  # one settings per composite bucket
            with self._lock:
                # poison() fails these from outside when the call below
                # wedges in a dead fleet's collective
                self._inflight = reqs
            try:
                t_dev = time.perf_counter()
                with TIMERS.stage("serve.batch"):
                    results = self.synth.synthesize_requests(
                        [dict(ref_wav=r.ref_wav, ref_sr=r.ref_sr, ref_units=r.ref_units,
                              gen_units=r.gen_units, seed=r.seed, rid=r._rid) for r in reqs],
                        cfg=cfg)
                now = time.perf_counter()
                with self._lock:
                    self._batch_sizes.append(len(reqs))
                for r, res in zip(reqs, results):
                    # trace before the future resolves: a reader of a done
                    # future finds its record written
                    if r._t_submit:
                        self.record_latency("request", now - r._t_submit)
                    self._trace(r, t_collect, now - t_dev, len(reqs), "ok")
                    if not r.future.done():  # a client may have given up
                        r.future.set_result(res)
                self.log.log("batch_done", size=len(reqs), bucket=bucket)
            except Exception as e:  # the worker must keep serving: fail this batch
                self.log.log("batch_error", error=str(e), tb=traceback.format_exc(limit=5))
                for r in reqs:
                    self._trace(r, t_collect, 0.0, len(reqs), "error")
                    if not r.future.done():
                        r.future.set_exception(e)
            finally:
                with self._lock:
                    self._inflight = []

    def _trace(self, req: TTSRequest, t_collect: float, batch_s: float, batch_size: int,
               outcome: str) -> None:
        """One request_trace record when tracing is on."""
        if not self.trace_requests:
            return
        now = time.perf_counter()
        trace_record(
            self.log, "request_trace", rid=req._rid, bucket=req._bucket,
            dur_bucket=req._dur_bucket, batch_size=batch_size,
            queue_wait_ms=round((t_collect - req._t_submit) * 1e3, 2) if req._t_submit else None,
            batch_ms=round(batch_s * 1e3, 2),
            total_ms=round((now - req._t_submit) * 1e3, 2) if req._t_submit else None,
            outcome=outcome)

    def poison(self, exc: BaseException) -> None:
        """Terminal degradation (the multi-process dispatch's
        ``on_degraded`` callback): fail every queued and running future now,
        without waiting on the worker, which may be stuck in a collective,
        and refuse new requests. The engine stays up, so ``/healthz`` and
        ``/stats`` keep answering."""
        with self._lock:
            if self._poisoned is not None:
                return
            self._poisoned = exc
            victims = list(self._pending.values()) + list(self._inflight)
            self._pending.clear()
        self.log.log("engine_poisoned", error=str(exc))
        for r in victims:
            if not r.future.done():
                r.future.set_exception(exc)

    # --------------------------------------------------------------- shutdown
    def shutdown(self):
        self._stop.set()
        self.batcher.close()
        self._worker.join(timeout=5)
        with self._lock:
            for r in self._pending.values():
                if not r.future.done():
                    r.future.set_exception(RuntimeError("engine shut down"))
            self._pending.clear()

    # -------------------------------------------------------------- metrics
    def record_latency(self, kind: str, seconds: float) -> None:
        """One latency sample (seconds) under ``kind``: ``request`` (the
        engine's) or ``stream_ttfb`` (the HTTP layer's)."""
        with self._lock:
            self._latencies.setdefault(kind, deque(maxlen=512)).append(seconds)

    @staticmethod
    def _percentiles(samples) -> Dict[str, float]:
        a = np.sort(np.asarray(samples, np.float64))

        def pick(q):
            return float(a[min(len(a) - 1, int(q * (len(a) - 1) + 0.5))])

        return {"count": len(a), "p50_ms": round(pick(0.50) * 1e3, 2),
                "p90_ms": round(pick(0.90) * 1e3, 2), "p99_ms": round(pick(0.99) * 1e3, 2),
                "max_ms": round(float(a[-1]) * 1e3, 2)}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lat = {k: self._percentiles(v) for k, v in self._latencies.items() if v}
            n_cfgs = len(self._cfg_ids)
            shed = dict(self._shed)
            sizes = list(self._batch_sizes)
        return {"queue_depth": self.batcher.depth(), "timers": TIMERS.snapshot(),
                "scheduler": "native" if self.batcher.is_native else "python",
                "latency": lat, "settings_variants": n_cfgs, "shed": shed,
                "batch_sizes": sizes,
                "degraded": str(self._poisoned) if self._poisoned else None}
