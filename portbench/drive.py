"""The measured window: closed-loop clients on the cell's entry point, the
benchmark's own spans around the calls into the program, and the profiled
slice of a traced run.

- ``serve``: the port's ``ServingEngine`` (C++ queue, ``max_batch``,
  ``max_wait_ms`` of the mix); each client submits a ``TTSRequest`` and waits
  on its Future, then sends its next. The engine talks to the synthesizer
  through ``Spans``, which records each ``synthesize_requests`` call.
- ``single``: one client calling ``Synthesizer.synthesize_chunks`` back to
  back, each call a span.

A request is timed from when its client issued it to when its wave is on the
host. Clients issue until the window closes; the requests in flight then
finish (the drain) and count for the tail, while the rate counts the audio
finished inside the window. A traced run profiles ``profile.batches``
whole device batches from ``profile.after`` of the window on.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from portbench import traffic as gen


@dataclass
class Record:
    index: int  # pool index
    t_issue: float
    t_done: float = 0.0
    ok: bool = False
    audio_s: float = 0.0
    error: str = ""
    out: Optional[tuple] = None  # (wave, sr, mel)


@dataclass
class Span:
    t0: float
    t1: float
    rows: int  # real rows
    n: int  # duration bucket
    durations: List[int]  # frames of every padded row


class Lines:
    """A stream for the engine's ``JsonLogger`` that keeps its records off
    standard output, whose last line is the result."""

    def write(self, s: str) -> None:
        pass

    def flush(self) -> None:
        pass


class Slice:
    """The traced run's profiler, over ``batches`` whole device batches from
    the first that begins at or after ``t_from``. The profiler starts and
    stops in the thread that owns it (``torch.profiler`` requires it): with
    ``threaded``, the engine's worker asks that thread (``control``) at each
    batch boundary and waits for it, so the slice holds whole batches only."""

    def __init__(self, enabled: bool, t_from: float, batches: int, threaded: bool = False):
        self.enabled, self.t_from, self.batches = enabled, t_from, batches
        self.threaded = threaded
        self.prof = None
        self.spans: List[Span] = []
        self.t0 = self.t1 = 0.0
        self.done = False
        self._ask = threading.Condition()
        self._want = None  # "start" | "stop" while the worker waits
        self.notes: List[str] = []  # what happened, for a slice that did not

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def _stop(self) -> None:
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.done = True

    def _request(self, what: str) -> None:
        self.notes.append(f"{time.perf_counter():.3f} {what} asked")
        if not self.threaded:
            (self._start if what == "start" else self._stop)()
            return
        with self._ask:
            self._want = what
            self._ask.notify_all()
            self._ask.wait_for(lambda: self._want is None, timeout=120)

    def before(self) -> None:
        if self.enabled and self.prof is None and not self.done \
                and time.perf_counter() >= self.t_from:
            self._request("start")

    def after(self, span: Span) -> None:
        if self.prof is not None and not self.done:
            self.spans.append(span)
            if len(self.spans) >= self.batches:
                self._request("stop")

    def control(self, until: float) -> None:
        """Serve the worker's start and stop requests until ``until`` (the
        owning thread)."""
        self.notes.append(f"{time.perf_counter():.3f} control from, until {until:.3f}")
        while time.perf_counter() < until and not self.done:
            with self._ask:
                self._ask.wait_for(lambda: self._want is not None, timeout=0.05)
                if self._want is None:
                    continue
                (self._start if self._want == "start" else self._stop)()
                self.notes.append(f"{time.perf_counter():.3f} {self._want} done")
                self._want = None
                self._ask.notify_all()
        self.notes.append(f"{time.perf_counter():.3f} control left")

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start on a
        card initialises the tracer for seconds, which must not fall into
        the window."""
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                pass

    def close(self) -> None:
        """Stop a slice the window cut short (it is then incomplete)."""
        if self.prof is not None and not self.done:
            self.prof.stop()
            self.prof = None


class Spans:
    """Stands between the engine and the synthesizer: forwards the two calls
    the engine makes and records a span around each device batch."""

    def __init__(self, synth, by_seed: Dict[int, gen.Request], prof: Slice):
        self._synth, self._by_seed, self._prof = synth, by_seed, prof
        self.spans: List[Span] = []

    def estimate_bucket(self, *args, **kwargs):
        return self._synth.estimate_bucket(*args, **kwargs)

    def synthesize_requests(self, requests, cfg):
        reqs = [self._by_seed[r["seed"]] for r in requests]
        n = max(r.bucket for r in reqs)
        padded = gen.pick_batch(len(reqs))
        durs = [r.durations[0] for r in reqs] + [2] * (padded - len(reqs))
        self._prof.before()
        t0 = time.perf_counter()
        out = self._synth.synthesize_requests(requests, cfg=cfg)
        span = Span(t0, time.perf_counter(), len(reqs), n, durs)
        self.spans.append(span)
        self._prof.after(span)
        return out


@dataclass
class Window:
    t_start: float
    seconds: float
    records: List[Record]
    spans: List[Span]
    slice: Optional[Slice] = None
    launches: Dict[str, int] = field(default_factory=dict)  # over the window


def _launch_counts() -> Dict[str, int]:
    from lemas_tts_tpu_torch.ops import launches

    return {k: int(f.launches) for k, f in launches.counters().items()}


def _delta(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {k: b[k] - a.get(k, 0) for k in b}


def serve(system, pool: List[gen.Request], traffic: dict, seed: int, seconds: float,
          trace: bool) -> Window:
    from lemas_tts_tpu_torch.serve.engine import ServingEngine, TTSRequest
    from lemas_tts_tpu_torch.utils.profiling import JsonLogger

    srv = traffic["server"]
    lines = Lines()
    prof = Slice(trace, 0.0, int(traffic["profile"]["batches"]), threaded=True)
    prof.warm()
    proxy = Spans(system.synth, {r.seed: r for r in pool}, prof)
    engine = ServingEngine(proxy, cfg=system.cfg, max_batch=int(srv["max_batch"]),
                           max_wait_ms=float(srv["max_wait_ms"]),
                           logger=JsonLogger(stream=lines), trace_requests=False)
    orders = gen.client_orders(traffic, seed, pool)
    timeout = float(traffic["request_timeout_s"])
    records: List[Record] = []
    before = _launch_counts()
    t_start = time.perf_counter()
    t_end = t_start + seconds
    prof.t_from = t_start + float(traffic["profile"]["after"]) * seconds

    def client(order):
        k = 0
        while time.perf_counter() < t_end:
            r = pool[int(order[k % len(order)])]
            k += 1
            rec = Record(r.index, time.perf_counter())
            try:
                fut = engine.submit(TTSRequest(r.ref_wav, r.ref_sr, r.ref_text, r.chunks[0],
                                               seed=r.seed))
                wave, sr, mel = fut.result(timeout=timeout)
                rec.t_done, rec.ok = time.perf_counter(), True
                rec.audio_s, rec.out = len(wave) / sr, (wave, sr, mel)
            except Exception as e:  # a failed request is counted, the client goes on
                rec.t_done, rec.error = time.perf_counter(), repr(e)
            records.append(rec)

    threads = [threading.Thread(target=client, args=(o,), daemon=True) for o in orders]
    for t in threads:
        t.start()
    if trace:
        prof.control(t_end + timeout)
    for t in threads:
        t.join(timeout=seconds + timeout + 60)
    prof.close()
    engine.shutdown()
    launches = _delta(before, _launch_counts())
    return Window(t_start, seconds, records, proxy.spans, prof, launches)


def single(system, pool: List[gen.Request], traffic: dict, seed: int, seconds: float,
           trace: bool) -> Window:
    synth, cfg = system.synth, system.cfg
    order = gen.client_orders(traffic, seed, pool)[0]
    prof = Slice(trace, 0.0, int(traffic["profile"]["batches"]))
    prof.warm()
    records: List[Record] = []
    spans: List[Span] = []
    before = _launch_counts()
    t_start = time.perf_counter()
    t_end = t_start + seconds
    prof.t_from = t_start + float(traffic["profile"]["after"]) * seconds
    k = 0
    while time.perf_counter() < t_end:
        r = pool[int(order[k % len(order)])]
        k += 1
        prof.before()
        rec = Record(r.index, time.perf_counter())
        try:
            wave, sr, mel = synth.synthesize_chunks(r.ref_wav, r.ref_sr, r.ref_text, r.chunks,
                                                    cfg=cfg, seed=r.seed)
            rec.t_done, rec.ok = time.perf_counter(), True
            rec.audio_s, rec.out = len(wave) / sr, (wave, sr, mel)
        except Exception as e:  # a failed request is counted, the loop goes on
            rec.t_done, rec.error = time.perf_counter(), repr(e)
        records.append(rec)
        span = Span(rec.t_issue, rec.t_done, len(r.chunks), r.bucket, list(r.durations))
        spans.append(span)
        prof.after(span)
    prof.close()
    launches = _delta(before, _launch_counts())
    return Window(t_start, seconds, records, spans, prof, launches)


ENTRIES = {"serve": serve, "single": single}


def rate_and_tail(w: Window, timeout_s: float) -> tuple:
    """Audio seconds finished inside the window per second of it, and the
    95th percentile of every request's latency in ms (a failed request
    counts as the timeout)."""
    end = w.t_start + w.seconds
    audio = sum(r.audio_s for r in w.records if r.ok and r.t_done <= end)
    lat = [(r.t_done - r.t_issue) * 1e3 if r.ok else timeout_s * 1e3 for r in w.records]
    return audio / w.seconds, (float(np.percentile(lat, 95)) if lat else None)
