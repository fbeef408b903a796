"""Multi-process serving of the port (``serve/multihost.py``,
``serve_http --multihost``) on a CPU process group of two.

Two jobs of two processes run this file as a script at once (gloo,
torchrun's environment, one torch thread a process, no JAX), each process
``serve_http.serve`` with ``--multihost --device cpu`` on the tiny config
(seeded random weights, NFE 4, float: int8's per-token rounding would turn
float noise into steps): process 0 serves HTTP, process 1 follows.

- Lockstep: the job starts with the warm-up on and ``--warmup_batches 1``
  (``Synthesizer.warmup`` and ``dispatch_warmup`` through the broadcast,
  so the follower joins one warm-up op and one warm-up dispatch); then
  four concurrent ``/tts`` requests and a ``/tts_stream`` are
  answered with the audio of a single-process ``serve_http`` in this test
  process on the same weights and requests (16-bit PCM within 1 step: the
  batch rows split otherwise over the processes, float sums in another
  order, ~1e-7); ``/stats`` carries the ``multihost`` block with both processes'
  dispatch and warm-up counts equal, ``/config`` says ``"multihost": true``;
  after a clean shutdown the follower's counters equal process 0's.
- Follower death: the follower is killed; ``/healthz`` answers 503 with
  ``degraded`` within the heartbeat timeout (5 s), ``/tts`` answers 503 and
  ``/stats`` still answers.
"""

import base64
import http.client
import io
import json
import os
import signal
import sys
import threading
import time
import warnings
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_parallel import REPO, free_port, start_ranks, wait_ranks

TINY = str(REPO / "tests" / "data" / "tiny.yaml")
HEARTBEAT_TIMEOUT = 5.0  # MultiHostDispatch's default
TEXTS = ("general kenobi.", "you are a bold one.", "hello there, old friend.", "back away.")


def server_argv(d: Path, port: int, multihost: bool, warm: bool = False) -> list:
    """``warm``: the warm-up on, and one dispatch-path warm-up batch of 1
    in the 512 bucket (the tiny config's 2 s synthetic reference fills 256)."""
    return (["--port", str(port), "--model", TINY, "--vocab_file", str(d / "vocab.txt"),
             "--frontend", "none", "--device", "cpu", "--nfe_step", "4", "--max_batch", "4",
             "--quant", "none"]
            + (["--warmup_batches", "1", "--warmup_durations", "512"] if warm
               else ["--no_warmup"])
            + (["--multihost"] if multihost else []))


def start_server(argv: list):
    """``serve_http.serve`` in a thread: (httpd, thread, its return box)."""
    from lemas_tts_tpu_torch.scripts import serve_http

    ready, box, ret = threading.Event(), [], []
    thread = threading.Thread(
        target=lambda: ret.append(serve_http.serve(serve_http.build_parser().parse_args(argv),
                                                    ready_event=ready, server_box=box)),
        daemon=True)
    thread.start()
    return ready, box, thread, ret


# ------------------------------------------------------------ one process
def rank_main(d: Path, port: int, warm: bool) -> None:
    """Process 0 serves until ``d/stop`` appears; a follower serves until
    process 0 shuts down. Each prints its result as JSON."""
    torch.set_num_threads(1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ready, box, thread, ret = start_server(server_argv(d, port, multihost=True, warm=warm))
        if os.environ["RANK"] != "0":
            thread.join()
            print(json.dumps(ret[0]), flush=True)
            return
        while not (d / "stop").exists():
            time.sleep(0.05)
        box[0][0].shutdown()
        thread.join(60)
    print(json.dumps({"ok": not thread.is_alive()}), flush=True)


# ------------------------------------------------------------ the test process
def call(port, method, path, body=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, body=None if body is None else json.dumps(body))
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def wait_healthy(port: int, procs: list, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if any(p.poll() is not None for p in procs):
            wait_ranks(procs)  # fails with the processes' output
            raise AssertionError("a process of the job ended before serving")
        try:
            if call(port, "GET", "/healthz", timeout=5)[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError("the server did not come up")


def pcm(data: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(data)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32)


def ask(port: int, ref_b64: str) -> dict:
    """Four concurrent /tts requests, then a /tts_stream: the PCM of each."""
    out = {}

    def one(i):
        status, data = call(port, "POST", "/tts", dict(ref_b64=ref_b64, ref_text="hello there.",
                                                       text=TEXTS[i], seed=20 + i))
        assert status == 200, data
        out[i] = pcm(data)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(TEXTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    status, data = call(port, "POST", "/tts_stream",
                        dict(ref_b64=ref_b64, ref_text="hello there.", seed=5, max_chars=20,
                             text="general kenobi. you are a bold one. back away now."))
    assert status == 200, data
    out["stream"] = np.frombuffer(data, "<i2").astype(np.int32)
    return out


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from lemas_tts_tpu_torch.utils.audio_io import write_wav

    d = tmp_path_factory.mktemp("mh")
    (d / "vocab.txt").write_text("\n".join([" "] + list("abcdefghijklmnopqrstuvwxyz")
                                           + [",", ".", "!"]) + "\n")
    rng = np.random.default_rng(0)
    ref = (0.2 * np.sin(2 * np.pi * 180 * np.arange(12000) / 16000)
           + 0.05 * rng.standard_normal(12000)).astype(np.float32)
    write_wav(str(d / "ref.wav"), ref, 16000)
    return d, base64.b64encode((d / "ref.wav").read_bytes()).decode()


@pytest.fixture(scope="module")
def jobs(workdir):
    """Both jobs started at once: (lockstep dir, port, procs), (death ...)."""
    d, _ = workdir
    out = []
    for name in ("lockstep", "death"):
        jd = d / name
        jd.mkdir()
        (jd / "vocab.txt").symlink_to(d / "vocab.txt")
        port = free_port()
        out.append((jd, port, start_ranks(__file__, 2, jd, port, int(name == "lockstep"))))
    yield out
    for _, _, procs in out:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()


def test_two_process_serving_matches_single_process(workdir, jobs):
    d, ref_b64 = workdir
    jd, port, procs = jobs[0]
    torch.set_num_threads(1)
    wait_healthy(port, procs)
    got = ask(port, ref_b64)
    status, data = call(port, "GET", "/stats")
    mh = json.loads(data)["multihost"]
    assert status == 200 and mh["processes"] == 2 and mh["in_lockstep"] is True, mh
    dispatches = [p["dispatches"] for p in mh["per_process"]]
    # the warm-up batch, >= 1 batch of the wave and the stream's mini-batches
    assert dispatches[0] == dispatches[1] >= 4, mh
    assert [p["warmups"] for p in mh["per_process"]] == [1, 1], mh
    assert json.loads(call(port, "GET", "/config")[1])["multihost"] is True
    assert call(port, "GET", "/healthz")[0] == 200
    (jd / "stop").touch()
    outs = wait_ranks(procs, timeout=120)
    assert json.loads(outs[0][0].strip().splitlines()[-1]) == {"ok": True}
    assert "dispatch-path warmup: 1 dispatches" in outs[0][0], outs[0][0]
    follower = json.loads(outs[1][0].strip().splitlines()[-1])
    assert follower == {"dispatches": dispatches[0], "warmups": 1}

    # the same requests to one process on the same (seeded) weights
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sport = free_port()
        ready, box, thread, _ = start_server(server_argv(d, sport, multihost=False))
        assert ready.wait(120)
    try:
        want = ask(sport, ref_b64)
    finally:
        box[0][0].shutdown()
        thread.join(30)
    for k, w in want.items():
        assert got[k].shape == w.shape and np.abs(got[k] - w).max() <= 1, k


def test_follower_death_degrades_within_the_heartbeat_timeout(workdir, jobs):
    _, ref_b64 = workdir
    jd, port, procs = jobs[1]
    wait_healthy(port, procs)
    status, _ = call(port, "POST", "/tts", dict(ref_b64=ref_b64, ref_text="hello there.",
                                                text="back away.", seed=1))
    assert status == 200
    procs[1].send_signal(signal.SIGKILL)
    t0 = time.monotonic()
    while True:
        status, data = call(port, "GET", "/healthz", timeout=10)
        if status == 503:
            break
        assert time.monotonic() - t0 < HEARTBEAT_TIMEOUT, "not degraded in time"
        time.sleep(0.05)
    body = json.loads(data)
    assert body["ok"] is False and "follower process 1" in body["degraded"]
    status, data = call(port, "POST", "/tts", dict(ref_b64=ref_b64, ref_text="hello there.",
                                                   text="back away.", seed=1))
    assert status == 503 and "degraded" in json.loads(data)["error"]
    status, data = call(port, "GET", "/stats", timeout=10)
    mh = json.loads(data)["multihost"]
    assert status == 200 and mh["in_lockstep"] is False and mh["degraded"]
    assert procs[0].poll() is None  # process 0 stays up to answer


if __name__ == "__main__":
    rank_main(Path(sys.argv[1]), int(sys.argv[2]), bool(int(sys.argv[3])))
