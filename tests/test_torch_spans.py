"""The port's stage spans and graph-capture counter on the CPU, and the
benchmark's readers of them on synthetic traces.

- Under a CPU ``torch.profiler``, one ``synthesize_chunks`` and one
  ``synthesize_requests`` on the tiny model each open ``synth.request``
  holding ``synth.prep``, ``synth.sample``, ``synth.vocode``, ``synth.fetch``
  and ``synth.finish``, once each and in that order; with no profiler no
  ``record_function`` is entered, and ``TIMERS`` counts every stage.
- A capture on a stand-in for CUDA adds one timed entry to ``CAPTURES`` and a
  ``graph.capture`` stage; a replay adds neither.
- ``request_trace`` names the batch's wall ``batch_ms``.
- ``portbench/metrics/{prep_ms, request_idle_ms, sampler_ms, vocoder_ms,
  graph_captures}.py`` on a two-call slice laid out by hand read the values
  worked out here, and None without the spans.
"""

import contextlib
import io
import json
import threading
import time
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

import torch
from torch.profiler import ProfilerActivity, profile

from lemas_tts_tpu_torch import TTS
from lemas_tts_tpu_torch.cfm import graph
from lemas_tts_tpu_torch.config import SamplerConfig
from lemas_tts_tpu_torch.serve.engine import ServingEngine, TTSRequest
from lemas_tts_tpu_torch.utils import profiling
from lemas_tts_tpu_torch.utils.profiling import TIMERS, JsonLogger
from portbench import spans
from portbench.drive import Span as CallSpan
from portbench.spec import Bench
from portbench.tests.tiny import REPO
from portbench.trace import Profile

TINY = "tests/data/tiny.yaml"
STAGES = ["synth.prep", "synth.sample", "synth.vocode", "synth.fetch", "synth.finish"]
CFG = SamplerConfig(nfe_steps=2, cfg_strength=2.0, sway_sampling_coef=1.0)


@pytest.fixture(scope="module")
def tts(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    (d / "vocab.txt").write_text("\n".join([" "] + list("abcdefghijklmnopqrstuvwxyz")) + "\n")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return TTS(model=TINY, vocab_file=str(d / "vocab.txt"), frontend=None, device="cpu")


def _call(tts, entry):
    ref = (0.1 * np.sin(2 * np.pi * 200 * np.arange(8000) / 16000)).astype(np.float32)
    if entry == "chunks":
        return tts.synth.synthesize_chunks(ref, 16000, "a b c ", ["hello there"], cfg=CFG,
                                           seed=1)
    return tts.synth.synthesize_requests(
        [dict(ref_wav=ref, ref_sr=16000, ref_units="a b c ", gen_units="hi there", seed=s)
         for s in (1, 2)], cfg=CFG)


@pytest.mark.parametrize("entry", ["chunks", "requests"])
def test_a_call_opens_its_stages_nested_in_order(tts, entry):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(tts, entry)
    got = sorted(spans.from_profiler(prof).spans, key=lambda s: (s.t0, -s.t1))
    assert [s.name for s in got] == ["synth.request"] + STAGES
    req, stages = got[0], got[1:]
    assert all(req.t0 <= s.t0 and s.t1 <= req.t1 and s.thread == req.thread for s in stages)
    assert all(a.t1 <= b.t0 for a, b in zip(stages, stages[1:]))


def test_stages_nest_under_the_profiler_and_keep_their_timers():
    timers = profiling.StageTimers()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.stage("synth.request", "call 7"):
            with timers.stage("synth.prep"):
                torch.zeros(3).add_(1)
    outer, inner = sorted(spans.from_profiler(prof).spans, key=lambda s: s.t0)
    assert (outer.name, inner.name) == ("synth.request", "synth.prep")
    assert outer.t0 <= inner.t0 and inner.t1 <= outer.t1
    snap = timers.snapshot()
    assert {k: v["count"] for k, v in snap.items()} == {"synth.request": 1, "synth.prep": 1}
    assert snap["synth.request"]["total_s"] >= snap["synth.prep"]["total_s"] > 0


@pytest.mark.parametrize("entry", ["chunks", "requests"])
def test_no_profiler_enters_no_range_and_timers_count_every_stage(tts, entry, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = TIMERS.snapshot()
    _call(tts, entry)
    after = TIMERS.snapshot()
    for name in ["synth.request"] + STAGES:
        assert after[name]["count"] == before.get(name, {"count": 0})["count"] + 1, name
        assert after[name]["max_s"] > 0


def test_a_capture_is_counted_and_timed_a_replay_is_not(monkeypatch):
    class Out:
        def record_stream(self, stream):
            pass

        def clone(self):
            return self

    class Graph:
        def replay(self):
            pass

        def pool(self):
            return "the pool"

    class Stream:
        def __init__(self, dev=None):
            pass

        def wait_stream(self, other):
            pass

    for name, stub in (("current_stream", Stream), ("Stream", Stream),
                       ("stream", lambda s: contextlib.nullcontext()), ("CUDAGraph", Graph),
                       ("graph", lambda g, **_: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, stub)
    monkeypatch.setattr(graph, "device_time_grid", lambda grid, dev: None)
    monkeypatch.setattr(graph, "sample_mel", lambda model, **_: Out())
    monkeypatch.setattr(graph, "CAPTURES", graph.Captures())
    g = graph.GraphedSampler("m", None, None, 1, 8, 4, 16, torch.device("cpu"),
                             graph.GraphPool())
    z = torch.zeros(1, 8, 4)
    args = (z, torch.zeros(1, 8, dtype=torch.bool), torch.zeros(1, 16, dtype=torch.int32),
            torch.full((1,), 8), z)
    timed = TIMERS.snapshot().get("graph.capture", {"count": 0})["count"]
    t0 = time.perf_counter()
    g(*args)  # the first call captures
    t1 = time.perf_counter()
    assert graph.CAPTURES.count == 1
    [(at, key)] = graph.CAPTURES.since(t0)
    assert t0 <= at <= t1 and key == (1, 8, 16, False)
    assert TIMERS.snapshot()["graph.capture"]["count"] == timed + 1
    g(*args)  # a replay
    assert graph.CAPTURES.count == 1 and len(graph.CAPTURES.since(t0)) == 1
    assert graph.CAPTURES.since(t1) == []
    assert TIMERS.snapshot()["graph.capture"]["count"] == timed + 1


def test_request_trace_names_the_batch_wall_batch_ms():
    assert list(profiling.REQUEST_TRACE_FIELDS) == [
        "rid", "bucket", "dur_bucket", "batch_size", "queue_wait_ms", "batch_ms", "total_ms",
        "outcome"]

    class Synth:
        def __init__(self):
            self.seen = []

        def estimate_bucket(self, *a):
            return 1024

        def synthesize_requests(self, requests, cfg):
            self.seen += requests
            return [(np.zeros(4, np.float32), 8000, None) for _ in requests]

    lines = io.StringIO()
    lock = threading.Lock()

    class Stream:
        def write(self, s):
            with lock:
                lines.write(s)

        def flush(self):
            pass

    synth = Synth()
    engine = ServingEngine(synth, max_batch=4, max_wait_ms=0.0, logger=JsonLogger(stream=Stream()),
                           trace_requests=True)
    try:
        fut = engine.submit(TTSRequest(np.zeros(800, np.float32), 8000, "a", "b", seed=3))
        fut.result(timeout=30)
    finally:
        engine.shutdown()
    with lock:
        records = [json.loads(x) for x in lines.getvalue().splitlines()]
    [rec] = [r for r in records if r["event"] == "request_trace"]
    assert rec["outcome"] == "ok" and rec["batch_ms"] >= 0 and "device_ms" not in rec
    assert [r["rid"] for r in synth.seen] == [rec["rid"]]


# ------------------------------------------------------- the benchmark's readers

K1 = "void sm90::gemm_sm90_kernel<128, 4, false, 0>(sm90::GemmMaps)"
K2 = "void sm90::gemm_sm90_kernel<128, 4, false, 2>(sm90::GemmMaps)"
K3 = "void (anonymous namespace)::attn_nhd_sm90_kernel<64, false>(CUtensorMap)"


def _call_ops(base, kernels=None):
    """One call laid out from ``base`` us: prep [0, 500] launching an upload
    that runs [300, 450]; sample [500, 600] launching 704 calls each of K1-K3,
    back to back over [600, 1600] on the device; vocode [600, 650], one
    kernel over [1600, 1800]; fetch [650, 1900], a copy over [1800, 1850];
    finish [1900, 2000]. Card busy 150 + 1250 us, idle 600 us of 2000."""
    names = kernels if kernels is not None else [K1, K2, K3] * 704
    step = 1000.0 / len(names)
    ops = [spans.Op("Memcpy HtoD", base + 300, base + 450, base + 200, 1)]
    ops += [spans.Op(n, base + 600 + i * step, base + 600 + (i + 1) * step, base + 550, 1)
            for i, n in enumerate(names)]
    ops += [spans.Op("vocos kernel", base + 1600, base + 1800, base + 620, 1),
            spans.Op("Memcpy DtoH", base + 1800, base + 1850, base + 660, 1)]
    marks = [("synth.request", 0, 2000), ("synth.prep", 0, 500), ("synth.sample", 500, 600),
             ("synth.vocode", 600, 650), ("synth.fetch", 650, 1900),
             ("synth.finish", 1900, 2000)]
    return [spans.Span(n, base + a, base + b, 1) for n, a, b in marks], ops


def _run(kernels=None, program=True, traced=True):
    """A traced single-stream run whose slice, from 10.0005 to 10.0065 s on
    the host's clock, made two calls (1024 bucket, one row) at 1000 and
    4000 us of the profiler's clock."""
    cfg = json.loads((REPO / "portbench/configs/multilingual.json").read_text())
    traffic = json.loads((REPO / "portbench/traffic/single-1chunk.json").read_text())
    s1, o1 = _call_ops(1000.0, kernels)
    s2, o2 = _call_ops(4000.0)
    calls = [CallSpan(10.001, 10.003, 1, 1024, [900]), CallSpan(10.004, 10.006, 1, 1024, [900])]
    sl = SimpleNamespace(prof=None, spans=calls, t0=10.0005, t1=10.0065)
    ops = o1 + o2
    run = SimpleNamespace(window=SimpleNamespace(slice=sl, t_start=9.0, seconds=45.0),
                          profile=Profile(0.006, [(o.name, o.t0, o.t1 - o.t0) for o in ops])
                          if traced else None,
                          arch=cfg["model"]["arch"], traffic=traffic)
    if traced:
        run.program_trace = spans.Trace(s1 + s2, ops) if program else None
    return run


@pytest.fixture(scope="module")
def read():
    bench = Bench(REPO)
    return {m: bench.reader(m) for m in ("prep_ms", "request_idle_ms", "sampler_ms",
                                         "vocoder_ms", "graph_captures")}


def test_readers_on_a_slice_laid_out_by_hand(read, capsys):
    run = _run()
    assert read["prep_ms"](run) == pytest.approx(0.5)
    assert read["request_idle_ms"](run) == pytest.approx(0.6)
    assert read["sampler_ms"](run) == pytest.approx(1.0)
    assert read["vocoder_ms"](run) == pytest.approx(0.2)
    err = capsys.readouterr().err
    assert "K1 704/704 704/704" in err and "K3 704/704 704/704" in err
    assert "(first start to last end): 1.000 (1.000) 1.000 (1.000)" in err
    assert "sum 0.003200 s = 53.333 %" in err and "device_idle_share 53.333 %" in err


def test_idle_split_by_the_innermost_span_at_each_gap(read):
    # gaps of the 6000 us wall (500 to 6500 us): [500, 1300] before the first
    # call, [1450, 1600] in its sample span, [2850, 4300] between the calls,
    # [4450, 4600], and [5850, 6500] after the last
    split = spans.idle_split(_run())
    assert split == pytest.approx({spans.OUTSIDE: (800 + 1450 + 650) / 1e6,
                                   "synth.sample": 300 / 1e6})


def test_sampler_ms_holds_each_call_to_its_kernel_calls(read):
    full = [K1, K2, K3] * 704
    assert read["sampler_ms"](_run(full[9:])) == pytest.approx(1.0)  # a few records lost
    assert read["sampler_ms"](_run(full[300:])) is None  # more than MIN_CALLS_FOUND allows
    assert read["sampler_ms"](_run(full + [K3])) is None  # a call more than the batch makes


@pytest.mark.parametrize("how", ["no_spans", "untraced"])
def test_readers_give_none_without_their_spans(read, how):
    run = _run(program=False) if how == "no_spans" else _run(traced=False)
    for name in ("prep_ms", "request_idle_ms", "sampler_ms", "vocoder_ms"):
        assert read[name](run) is None, name
    assert spans.idle_split(run) is None


def test_graph_captures_counts_the_window(read, monkeypatch):
    captures = graph.Captures()
    monkeypatch.setattr(graph, "CAPTURES", captures)
    t0 = time.perf_counter()
    captures.add((1, 1024, 256, False))
    t1 = time.perf_counter()
    captures.add((1, 1536, 256, False))

    def window(start, seconds=100.0):
        return SimpleNamespace(window=SimpleNamespace(t_start=start, seconds=seconds))

    assert read["graph_captures"](window(t0)) == 2
    assert read["graph_captures"](window(t1)) == 1
    assert read["graph_captures"](window(t1 + 100.0)) == 0
    assert read["graph_captures"](window(t0 - 100.0, 50.0)) == 0
