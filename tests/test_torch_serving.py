"""The port's serving path on the CPU: batched and streamed requests, the
engine's batching, cancel and shedding, and ``serve_http`` on a free port.

- ``synthesize_requests`` (each row its own reference, seed and noise)
  against one ``synthesize_chunks`` per request, and ``synthesize_stream``
  against ``synthesize_chunks(return_parts=True)``, on the tiny config in
  f32, plain and at the serving settings (CFG cutoff 0.5, block cache
  "0-22:2+t2" clamped to the tiny depth). The requests land in one duration
  bucket, so a row's noise is the same in both; tolerance 2e-4 of the peak
  (a batch of other rows sums in another order).
- The engine with a stub synthesizer that blocks on events (never on
  sleeps): requests that queue while a batch runs form the next batch; a
  queued request cancels; an expired one is shed with TimeoutError.
- ``GraphedSampler``'s launch counts with two first calls at once, on a
  stand-in for CUDA (the graph calls are stubs, the sampler counts launches
  and blocks on events): one bucket's eager run falls inside the other's
  capture, and each graph still records only its own launches.
- ``serve_http`` at its defaults (int8, cutoff 0.5, block cache) on the CPU:
  /healthz, /config, /tts, /tts_stream, a bad payload (400), a bad path
  (404); ``--multihost`` raises.
"""

import base64
import http.client
import json
import threading
import warnings
from concurrent.futures import CancelledError

import numpy as np
import pytest

from lemas_tts_tpu.infer.pipeline import Synthesizer as JSynthesizer
from lemas_tts_tpu_torch import TTS
from lemas_tts_tpu_torch.config import SamplerConfig
from lemas_tts_tpu_torch.infer import pipeline
from lemas_tts_tpu_torch.scripts import serve_http
from lemas_tts_tpu_torch.serve.engine import ServingEngine, TTSRequest
from lemas_tts_tpu_torch.utils.audio_io import write_wav

TINY = "tests/data/tiny.yaml"
VOCAB = [" "] + list("abcdefghijklmnopqrstuvwxyz") + [",", ".", "!"]
CFGS = {"plain": SamplerConfig(nfe_steps=3, cfg_strength=2.0, sway_sampling_coef=1.0),
        "serving": SamplerConfig(nfe_steps=4, cfg_strength=2.0, sway_sampling_coef=1.0,
                                 cfg_cutoff=0.5, block_cache="0-22:2+t2")}


@pytest.fixture(scope="module")
def tts(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving")
    (d / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = TTS(model=TINY, vocab_file=str(d / "vocab.txt"), frontend=None, device="cpu")
    t.workdir = d
    return t


def _ref(seed, n=12000, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (0.2 * np.sin(2 * np.pi * (150 + 20 * seed) * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", list(CFGS))
def test_synthesize_requests_matches_chunks(tts, name):
    cfg = CFGS[name]
    reqs = [dict(ref_wav=_ref(i, n=8000 + 400 * i), ref_sr=16000, ref_units="hello there. ",
                 gen_units=text, seed=10 + i)
            for i, text in enumerate(["general kenobi.", "you are a bold one.",
                                      "hello again, friend."])]
    synth = tts.synth
    buckets = {synth.estimate_bucket(r["ref_wav"], 16000, r["ref_units"], r["gen_units"], cfg)
               for r in reqs}
    assert len(buckets) == 1, buckets
    got = synth.synthesize_requests(reqs, cfg=cfg)
    assert len(got) == len(reqs)
    for r, (w, sr, mel) in zip(reqs, got):
        jw, jsr, jmel = synth.synthesize_chunks(r["ref_wav"], 16000, r["ref_units"],
                                                [r["gen_units"]], cfg=cfg, seed=r["seed"])
        assert sr == jsr == 8000 and mel.shape == jmel.shape and w.shape == jw.shape
        _close(mel, jmel)
        _close(w, jw)


@pytest.mark.parametrize("name", list(CFGS))
def test_synthesize_stream_matches_chunks(tts, name):
    cfg = CFGS[name]
    chunks = ["general kenobi.", "you are a bold one.", "hello again, friend.", "so long now."]
    args = (_ref(0), 16000, "hello there. ", chunks)
    want, sr, _ = tts.synth.synthesize_chunks(*args, cfg=cfg, seed=4, return_parts=True)
    got = list(tts.synth.synthesize_stream(*args, cfg=cfg, seed=4, chunk_batch=2,
                                           first_chunk_batch=1))
    assert len(got) == len(want) == len(chunks)
    for (w, wsr), ref in zip(got, want):
        assert wsr == sr and w.shape == ref.shape
        _close(w, ref)


@pytest.mark.parametrize("n,chunk_batch,first", [(1, 2, None), (5, 2, 1), (7, 3, 2), (4, 0, 9)])
def test_stream_plan_matches_jax(tts, n, chunk_batch, first):
    cfg, first_cfg = SamplerConfig(), SamplerConfig(nfe_steps=8)
    got = tts.synth._stream_plan(n, cfg, chunk_batch, first, first_cfg)
    want = JSynthesizer._stream_plan(None, n, cfg, chunk_batch, first, first_cfg)
    assert got == want


def test_warmup_on_cpu(tts):
    """The CPU captures no graph; the dispatch-path warm-up runs real
    requests, one per (duration, batch) bucket it can reach (its 2 s
    reference cannot reach the 256-frame bucket; 500 is taken to 512)."""
    cfg = CFGS["plain"]
    assert tts.synth.warmup(cfg, duration_buckets=(256,), batch_buckets=(1, 2)) == 0
    assert pipeline.dispatch_warmup(tts.synth, cfg, duration_buckets=(256, 500),
                                    batch_buckets=(1, 2)) == 2


class StubSynth:
    """Records each batch's size; the first batch blocks until released."""

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()
        self.sizes = []

    def estimate_bucket(self, *a):
        return 1024

    def synthesize_requests(self, requests, cfg):
        self.sizes.append(len(requests))
        self.entered.set()
        assert self.release.wait(30)
        return [(np.full(4, r["seed"], np.float32), 8000, None) for r in requests]


def _req(seed, **kw):
    return TTSRequest(np.zeros(800, np.float32), 8000, "a", "b", seed=seed, **kw)


def test_engine_batches_queued_requests():
    stub = StubSynth()
    engine = ServingEngine(stub, max_batch=8, max_wait_ms=0.0)
    try:
        first = engine.submit(_req(0))
        assert stub.entered.wait(30)  # the worker holds batch 1 on the device
        rest = [engine.submit(_req(i)) for i in range(1, 6)]
        assert engine.batcher.depth() == 5
        stub.release.set()
        for i, f in enumerate([first] + rest):
            assert f.result(timeout=30)[0][0] == i
        assert stub.sizes == [1, 5] and engine.stats()["batch_sizes"] == [1, 5]
    finally:
        stub.release.set()
        engine.shutdown()


def test_engine_cancel_and_shed():
    stub = StubSynth()
    engine = ServingEngine(stub, max_batch=8, max_wait_ms=0.0)
    try:
        first = engine.submit(_req(0))
        assert stub.entered.wait(30)
        gone = engine.submit(_req(1))
        expired = engine.submit(_req(2, timeout=0.0))
        kept = engine.submit(_req(3))
        assert engine.cancel(gone) and gone.cancelled()
        assert engine.batcher.depth() == 2
        stub.release.set()
        assert first.result(timeout=30)[0][0] == 0 and kept.result(timeout=30)[0][0] == 3
        with pytest.raises(TimeoutError):
            expired.result(timeout=30)
        with pytest.raises(CancelledError):
            gone.result(timeout=0)
        assert engine.stats()["shed"] == {"cancelled": 1, "timed_out": 1}
        assert stub.sizes == [1, 1]
    finally:
        stub.release.set()
        engine.shutdown()


def test_graph_capture_records_only_its_own_launches(monkeypatch):
    """Two buckets' first calls in two threads: B's eager run (5 launches a
    kernel) happens while A captures (3). The counters get each eager run
    once, each graph records its own launches, and a replay adds them."""
    import contextlib

    import torch

    from lemas_tts_tpu_torch.cfm import graph
    from lemas_tts_tpu_torch.ops import launches

    wrappers = launches.counters()
    for f in wrappers.values():
        monkeypatch.setattr(f, "launches", 0)

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

    in_capture = threading.local()

    @contextlib.contextmanager
    def capture(g, **_):
        in_capture.on = True
        try:
            yield
        finally:
            in_capture.on = False

    for name, stub in (("current_stream", Stream), ("Stream", Stream),
                       ("stream", lambda s: contextlib.nullcontext()),
                       ("CUDAGraph", Graph), ("graph", capture)):
        monkeypatch.setattr(torch.cuda, name, stub)
    monkeypatch.setattr(graph, "device_time_grid", lambda grid, dev: None)
    a_capturing, b_eager_done = threading.Event(), threading.Event()

    def sample_mel(model, **_):
        capturing = getattr(in_capture, "on", False)
        if model == "A" and capturing:
            a_capturing.set()
            assert b_eager_done.wait(60)
        for _ in range(3 if model == "A" else 5):
            for f in wrappers.values():
                launches.count(f)
        if model == "B" and not capturing:
            b_eager_done.set()
        return Out()

    monkeypatch.setattr(graph, "sample_mel", sample_mel)
    pool = graph.GraphPool()
    samplers = {m: graph.GraphedSampler(m, None, None, 1, 8, 4, 4, torch.device("cpu"), pool)
                for m in "AB"}
    def first_call_b():
        assert a_capturing.wait(60)
        samplers["B"].capture()

    threads = [threading.Thread(target=samplers["A"].capture),
               threading.Thread(target=first_call_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert b_eager_done.is_set() and not any(t.is_alive() for t in threads)
    assert getattr(launches._local, "record", None) is None and pool.handle == "the pool"
    assert {k: f.launches for k, f in wrappers.items()} == dict.fromkeys(wrappers, 3 + 5)
    for m, n in (("A", 3), ("B", 5)):
        assert samplers[m].launches_per_replay == dict.fromkeys(wrappers, n)
    z = torch.zeros(1, 8, 4)
    samplers["B"](z, torch.zeros(1, 8, dtype=torch.bool), torch.zeros(1, 4, dtype=torch.int32),
                  torch.full((1,), 8), z)
    assert {k: f.launches for k, f in wrappers.items()} == dict.fromkeys(wrappers, 3 + 5 + 5)


@pytest.fixture(scope="module")
def server(tts):
    d = tts.workdir
    args = serve_http.build_parser().parse_args(
        ["--port", "0", "--model", TINY, "--vocab_file", str(d / "vocab.txt"), "--frontend",
         "none", "--device", "cpu", "--nfe_step", "3", "--no_warmup"])
    ready, box = threading.Event(), []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        thread = threading.Thread(target=serve_http.serve, args=(args,),
                                  kwargs=dict(ready_event=ready, server_box=box), daemon=True)
        thread.start()
        assert ready.wait(120)
    httpd, engine = box[0]
    ref = d / "ref.wav"
    write_wav(str(ref), _ref(0), 16000)
    yield httpd.server_address[1], base64.b64encode(ref.read_bytes()).decode()
    httpd.shutdown()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=None if body is None else json.dumps(body))
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp, data


def test_serve_http_endpoints(server):
    port, ref_b64 = server
    resp, data = _call(port, "GET", "/healthz")
    assert resp.status == 200 and json.loads(data)["ok"] is True
    resp, data = _call(port, "GET", "/config")
    cfg = json.loads(data)
    assert resp.status == 200 and (cfg["quant"], cfg["block_cache"], cfg["cfg_cutoff"],
                                   cfg["nfe_steps"], cfg["device"]) == (
        "int8", "0-22:2+t2", 0.5, 3, "cpu")
    resp, data = _call(port, "POST", "/tts", dict(ref_b64=ref_b64, ref_text="hello there",
                                                  text="general kenobi", seed=1))
    assert resp.status == 200 and resp.getheader("Content-Type") == "audio/wav"
    with open_wav(data) as w:
        assert w.getframerate() == 8000 and w.getnframes() > 0
    resp, data = _call(port, "GET", "/stats")
    assert resp.status == 200 and json.loads(data)["batch_sizes"] == [1]


def open_wav(data: bytes):
    import io
    import wave

    return wave.open(io.BytesIO(data), "rb")


def test_serve_http_stream(server):
    port, ref_b64 = server
    resp, data = _call(port, "POST", "/tts_stream",
                       dict(ref_b64=ref_b64, ref_text="hello there", seed=2, chunk_batch=2,
                            text="general kenobi.\nyou are a bold one.\nso long."))
    assert resp.status == 200 and resp.getheader("Content-Type").startswith("audio/L16")
    pcm = np.frombuffer(data, "<i2")
    assert pcm.size > 0 and np.abs(pcm).max() > 0


def test_serve_http_takes_a_burst_of_connects(server):
    """The listen backlog holds a burst of connects beyond the standard
    library's 5 (a stack that resets past the backlog dropped one request of
    a wave of 8 on the H100 machine), and 32 clients connecting at once all
    get their answer."""
    port, _ = server
    assert serve_http.HTTPServer.request_queue_size >= 64 > 5 == \
        serve_http.ThreadingHTTPServer.request_queue_size
    codes, go = [], threading.Barrier(32)

    def client():
        go.wait(30)
        codes.append(_call(port, "GET", "/healthz")[0].status)

    threads = [threading.Thread(target=client) for _ in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads) and codes == [200] * 32


@pytest.mark.parametrize("body,with_ref,path,status", [
    (dict(text=""), True, "/tts", 400), (dict(text="hi"), False, "/tts", 400),
    (dict(text="hi", nfe_step=999), True, "/tts", 400),
    (dict(text="hi", block_cache="9-1:2"), True, "/tts", 400),
    (dict(text=""), True, "/tts_stream", 400), ({}, False, "/nope", 404)])
def test_serve_http_refuses_bad_requests(server, body, with_ref, path, status):
    port, ref_b64 = server
    resp, data = _call(port, "POST", path, dict(body, ref_b64=ref_b64) if with_ref else body)
    assert resp.status == status and "error" in json.loads(data)


def test_serve_http_multihost_refused():
    args = serve_http.build_parser().parse_args(["--multihost", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        serve_http.serve(args)
