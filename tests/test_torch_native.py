"""The port's C++ host runtime (``lemas_tts_tpu_torch/native``, built from
``csrc/host``) against the JAX package's on the CPU: the JAX
``test_native.py`` cases (the batcher's over ``native=True/False``, the
pure-Python queue being ``native=False``), the WAV codec bit for bit against
the JAX native decoder and the numpy reader, the silence scan and
``remove_long_silence`` equal to JAX's, the serving paths that decode with
it, the build under four processes at once on an empty directory and a
failed build raising, and ``read_audio``'s other containers through a fake
``ffmpeg``/``ffprobe`` and a fake ``soundfile``."""

import base64
import ctypes
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import torch

from lemas_tts_tpu.native import audio as jaudio
from lemas_tts_tpu_torch import native
from lemas_tts_tpu_torch.native import audio
from lemas_tts_tpu_torch.native.batcher import Batcher
from lemas_tts_tpu_torch.utils.audio_io import decode_wav, read_audio, write_wav

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_audioproc(tmp_path_factory):
    """The JAX package's ``native/audioproc.cpp``, built with the flags of
    ``native/Makefile`` into this module's own directory: the JAX loader
    builds into a shared ``native/build`` that parallel workers may be
    building at the same time."""
    so = tmp_path_factory.mktemp("jax_audioproc") / "libaudioproc.so"
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
                    "-fvisibility=hidden", "-shared", "-o", str(so),
                    str(REPO / "native" / "audioproc.cpp")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(so))


@pytest.fixture
def jnative(jax_audioproc, monkeypatch):
    """``lemas_tts_tpu.native.audio`` on that library (its own argtypes)."""
    monkeypatch.setattr(jaudio, "_lib", None)
    monkeypatch.setattr(jaudio, "_checked", False)
    monkeypatch.setattr(jaudio, "load_library", lambda name: jax_audioproc)
    assert jaudio.native_available()
    return jaudio


def sine(sr=16000, seconds=1.0, amp=0.5, f=440.0):
    t = np.arange(int(sr * seconds)) / sr
    return (amp * np.sin(2 * np.pi * f * t)).astype(np.float32)


# ------------------------------------------------------------------- audio
def test_wav_roundtrip_pcm16():
    sr = 16000
    x = sine(sr)
    dec, dsr = audio.wav_decode(audio.wav_encode(x, sr))
    assert dsr == sr and dec.shape == (1, sr)
    assert np.abs(dec[0] - x).max() < 2e-4  # PCM16 quantization


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_codec_bit_equal_to_jax_and_numpy(channels, tmp_path, jnative):
    """``wav_decode`` equals the JAX native decoder and the numpy reader bit
    for bit; ``wav_encode`` writes the JAX encoder's bytes."""
    rng = np.random.default_rng(channels)
    x = np.clip(0.3 * rng.standard_normal((channels, 8000)), -1, 1).astype(np.float32)
    blob = audio.wav_encode(x, 8000)
    assert blob == jnative.wav_encode(x, 8000)
    p = tmp_path / "x.wav"
    write_wav(str(p), x, 8000)
    got, sr = audio.wav_decode(p.read_bytes())
    want, jsr = jnative.wav_decode(p.read_bytes())
    ref, rsr = decode_wav(p.read_bytes())
    assert sr == jsr == rsr == 8000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


def test_wav_stereo():
    x = np.stack([np.full(100, 0.5, np.float32), np.full(100, -0.5, np.float32)])
    dec, _ = audio.wav_decode(audio.wav_encode(x, 8000))
    assert dec.shape == (2, 100)
    assert dec[0].mean() > 0.49 and dec[1].mean() < -0.49


def test_wav_decode_truncated_and_8bit():
    """A header claiming more data than there is: clamped, never read past
    the end; 8-bit PCM and a short blob give None (the numpy reader takes
    8-bit)."""
    x = sine(8000)
    blob = audio.wav_encode(x, 8000)
    for cut in (60, 100, 500):
        dec, sr = audio.wav_decode(blob[:cut])
        assert sr == 8000 and dec.shape[1] <= (cut - 44) // 2 + 1 and np.isfinite(dec).all()
    assert audio.wav_decode(blob[:30]) is None
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(1)
        w.setframerate(8000)
        w.writeframes(bytes(range(256)))
    assert audio.wav_decode(buf.getvalue()) is None
    assert decode_wav(buf.getvalue())[0].shape == (1, 256)


@pytest.mark.parametrize("rates", [(16000, 24000), (24000, 16000), (44100, 24000)])
def test_resample_matches_jax_native_and_the_port_kernel(rates, jnative):
    from lemas_tts_tpu_torch.ops.resample import resample

    x = (0.5 * np.random.default_rng(1).standard_normal(4000)).astype(np.float32)
    got = audio.resample(x, *rates)
    np.testing.assert_array_equal(got, jnative.resample(x, *rates))
    plain = resample(torch.from_numpy(x), *rates).numpy()
    n = min(len(got), len(plain))
    assert abs(len(got) - len(plain)) <= 1
    np.testing.assert_allclose(got[:n], plain[:n], atol=5e-4)


def test_rms_and_dbfs():
    assert abs(audio.rms(np.full(1000, 0.1, np.float32)) - 0.1) < 1e-6
    sr = 8000
    sig = np.concatenate([np.zeros(sr, np.float32), np.full(sr, 0.5, np.float32)])
    prof = audio.scan_dbfs(sig, sr, 1000, 10)
    assert prof[0] < -100 and prof[-1] > -7
    assert audio.version() == "audioproc 1.0 (lemas-tts-tpu)"


def test_scan_dbfs_and_silence_ops_equal_jax(jnative):
    """``scan_dbfs`` equals the JAX native scan bit for bit; the silence ops
    built on it (``detect_silence``, ``remove_long_silence``,
    ``clip_ref_audio``) equal the JAX package's."""
    from lemas_tts_tpu.infer import audio_prep as jprep

    from lemas_tts_tpu_torch.infer import audio_prep

    sr = 8000
    rng = np.random.default_rng(2)
    parts = [0.3 * rng.standard_normal(sr * 2), np.zeros(int(sr * 1.7)),
             0.2 * rng.standard_normal(sr), 1e-4 * rng.standard_normal(int(sr * 2.3)),
             0.25 * rng.standard_normal(sr // 2)]
    x = np.concatenate(parts).astype(np.float32)
    np.testing.assert_array_equal(audio.scan_dbfs(x, sr, 1000, 10),
                                  jnative.scan_dbfs(x, sr, 1000, 10))
    assert audio_prep.detect_silence(x, sr) == jprep.detect_silence(x, sr)
    got = audio_prep.remove_long_silence(x, sr)
    np.testing.assert_array_equal(got, jprep.remove_long_silence(x, sr))
    assert len(got) < len(x)
    np.testing.assert_array_equal(audio_prep.clip_ref_audio(x, sr, show_info=lambda *a: None),
                                  jprep.clip_ref_audio(x, sr, show_info=lambda *a: None))


@pytest.mark.parametrize("bits", [8, 16])
def test_serve_http_decode_ref_matches_jax(bits, jnative):
    """``serve_http._decode_ref`` of a ``ref_b64`` WAV: the C++ codec for
    16-bit, the numpy reader for the 8-bit one it does not take; equal to
    the JAX server's."""
    import io
    import wave

    from lemas_tts_tpu.scripts import serve_http as jserve

    from lemas_tts_tpu_torch.scripts import serve_http

    x = np.stack([sine(8000, 0.5), sine(8000, 0.5, 0.2, 220.0)])
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(bits // 8)
        w.setframerate(8000)
        pcm = (np.round(x.T * 127) + 128).astype(np.uint8) if bits == 8 else \
            (x.T * 32767).astype("<i2")
        w.writeframes(pcm.tobytes())
    payload = {"ref_b64": base64.b64encode(buf.getvalue()).decode()}
    got, sr = serve_http._decode_ref(payload)
    want, jsr = jserve._decode_ref(payload)
    assert sr == jsr == 8000
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


# ----------------------------------------------------------------- batcher
@pytest.mark.parametrize("native_", [True, False])
def test_batcher_basic(native_):
    b = Batcher(max_batch=4, max_wait_ms=5, native=native_)
    assert b.is_native is native_
    ids = [b.submit(bucket=1024, cost=10) for _ in range(6)]
    assert all(i > 0 for i in ids)
    got1, bucket1 = b.next_batch(timeout_ms=200)
    got2, _ = b.next_batch(timeout_ms=200)
    assert got1 == ids[:4] and bucket1 == 1024
    assert got2 == ids[4:]
    assert b.depth() == 0
    b.close()
    assert b.submit(bucket=1) == 0


@pytest.mark.parametrize("native_", [True, False])
def test_batcher_buckets_not_mixed(native_):
    b = Batcher(max_batch=8, max_wait_ms=1, native=native_)
    a = b.submit(bucket=512)
    time.sleep(0.002)
    c = b.submit(bucket=1024)
    got1, bucket1 = b.next_batch(timeout_ms=200)
    got2, bucket2 = b.next_batch(timeout_ms=200)
    assert got1 == [a] and bucket1 == 512  # one batch per bucket, oldest first
    assert got2 == [c] and bucket2 == 1024
    b.close()


@pytest.mark.parametrize("native_", [True, False])
def test_batcher_max_cost(native_):
    b = Batcher(max_batch=8, max_cost=25, max_wait_ms=1, native=native_)
    ids = [b.submit(bucket=1, cost=10) for _ in range(4)]
    got, _ = b.next_batch(timeout_ms=200)
    assert got == ids[:2]  # 10 + 10 <= 25 < 10 + 10 + 10
    b.close()


@pytest.mark.parametrize("native_", [True, False])
def test_batcher_concurrent_producers(native_):
    b = Batcher(max_batch=16, max_wait_ms=10, native=native_)

    def produce():
        for _ in range(8):
            assert b.submit(bucket=256, cost=1) > 0

    threads = [threading.Thread(target=produce) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seen = []
    while True:
        got, _ = b.next_batch(timeout_ms=50)
        if not got:
            break
        seen.extend(got)
    assert sorted(seen) == sorted(set(seen)) and len(seen) == 32
    b.close()


@pytest.mark.parametrize("native_", [True, False])
def test_batcher_timeout_empty(native_):
    b = Batcher(max_batch=4, native=native_)
    t0 = time.monotonic()
    got, _ = b.next_batch(timeout_ms=30)
    assert got == [] and time.monotonic() - t0 < 5.0
    b.close()


@pytest.mark.parametrize("native_", [True, False])
def test_batcher_multi_consumer(native_):
    """Two consumers racing over one queue: every id delivered once."""
    b = Batcher(max_batch=2, max_wait_ms=5, native=native_)
    got, lock = [], threading.Lock()

    def consume():
        while True:
            ids, _ = b.next_batch(timeout_ms=100)
            if not ids:
                break
            with lock:
                got.extend(ids)

    consumers = [threading.Thread(target=consume) for _ in range(2)]
    for t in consumers:
        t.start()
    submitted = [b.submit(bucket=128, cost=1) for _ in range(40)]
    for t in consumers:
        t.join()
    assert sorted(got) == sorted(submitted)
    b.close()


@pytest.mark.parametrize("native_", [True, False])
def test_batcher_cancel_and_wider_window(native_):
    """A queued request cancels; a window wider than its latecomers' delay
    holds a batch open for them."""
    b = Batcher(max_batch=3, max_wait_ms=2000, native=native_)
    rid = b.submit(bucket=1)
    assert b.cancel(rid) and not b.cancel(rid) and b.depth() == 0
    first = b.submit(bucket=1)
    late = threading.Timer(0.2, lambda: [b.submit(bucket=1) for _ in range(2)])
    late.start()
    got, _ = b.next_batch(timeout_ms=100)
    late.join()
    assert got[0] == first and len(got) == 3
    b.close()


def test_serving_engine_takes_the_native_scheduler():
    from lemas_tts_tpu_torch.serve.engine import ServingEngine

    engine = ServingEngine(object())
    try:
        assert engine.batcher.is_native and engine.stats()["scheduler"] == "native"
    finally:
        engine.shutdown()


# ------------------------------------------------------------------- build
_BUILD = """
import sys
from pathlib import Path
from lemas_tts_tpu_torch import native
native.BUILD = Path(sys.argv[1])
from lemas_tts_tpu_torch.native import audio, batcher
print(audio.version(), batcher.Batcher(max_batch=2).is_native)
"""


def test_build_is_safe_from_four_processes(tmp_path):
    """Four processes that load the host libraries at once on an empty build
    directory: each loads them, and each library was built once (one file,
    no temporary left)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["audioproc", "1.0", "(lemas-tts-tpu)", "True"]
    names = sorted(f.name for f in tmp_path.iterdir() if not f.name.startswith("."))
    assert names == sorted([native.library_path("audioproc").name,
                            native.library_path("scheduler").name])


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that fails gives ``RuntimeError`` with its
    output, and no library is left behind."""
    monkeypatch.setattr(native, "BUILD", tmp_path)
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building audioproc.cpp failed"):
        native.load_library("audioproc")
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


def test_host_sources_are_the_jax_copies():
    """``csrc/host/*.cpp`` are byte copies of the JAX package's ``native/``
    sources."""
    src = REPO / "lemas_tts_tpu_torch" / "csrc" / "host"
    for name in ("audioproc.cpp", "scheduler.cpp"):
        assert (src / name).read_bytes() == (REPO / "native" / name).read_bytes(), name


# --------------------------------------------------------- other containers
_FAKE_FFMPEG = """#!{py}
import sys
import numpy as np
sys.stdout.buffer.write((0.25 * np.sin(np.arange(4000) / 7.0)).astype("<f4").tobytes())
"""
_FAKE_FFPROBE = """#!/bin/sh
echo 22050
"""


def _fake_tools(d: Path, probe: bool = True) -> None:
    d.mkdir()
    (d / "ffmpeg").write_text(_FAKE_FFMPEG.format(py=sys.executable))
    (d / "ffmpeg").chmod(0o755)
    if probe:
        (d / "ffprobe").write_text(_FAKE_FFPROBE)
        (d / "ffprobe").chmod(0o755)


@pytest.mark.parametrize("probe", [True, False])
def test_read_audio_through_ffmpeg_matches_jax(probe, tmp_path, monkeypatch):
    """A non-WAV container with ``ffmpeg`` (and ``ffprobe`` for the rate, 24
    kHz without it) on ``PATH``: mono float32, equal to the JAX reader's."""
    from lemas_tts_tpu.utils import audio_io as jaudio_io

    _fake_tools(tmp_path / "bin", probe)
    monkeypatch.setitem(sys.modules, "soundfile", None)
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    (tmp_path / "a.mp3").write_bytes(b"ID3")
    got, sr = read_audio(str(tmp_path / "a.mp3"))
    want, jsr = jaudio_io.read_audio(str(tmp_path / "a.mp3"))
    assert sr == jsr == (22050 if probe else 24000)
    assert got.shape == (1, 4000) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_read_audio_through_soundfile(tmp_path, monkeypatch):
    """``soundfile``, when it imports, reads the other containers
    (``[T, channels]`` -> ``[channels, T]``)."""
    import types

    data = np.stack([np.linspace(-1, 1, 50), np.linspace(1, -1, 50)], 1).astype(np.float32)
    fake = types.ModuleType("soundfile")
    fake.read = lambda path, dtype, always_2d: (data, 44100)
    monkeypatch.setitem(sys.modules, "soundfile", fake)
    got, sr = read_audio(str(tmp_path / "x.flac"))
    assert sr == 44100 and got.shape == (2, 50)
    np.testing.assert_array_equal(got, data.T)
