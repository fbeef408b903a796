"""Host-side audio file IO (counterpart of ``lemas_tts_tpu/utils/audio_io.py``).

WAV goes through the C++ codec (``native/audio.py:wav_decode``: 16-, 24- and
32-bit PCM and IEEE float32), and what it does not take (8-bit PCM) through
the numpy decoder ``decode_wav``, which reads the same formats. Other
containers go through ``soundfile`` when it is importable, else through
``ffmpeg`` (``-f f32le -ac 1``, mono) with ``ffprobe`` for the rate, as in
the JAX package; with neither, ``read_audio`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import wave
from typing import Tuple

import numpy as np

_PCM, _FLOAT, _EXTENSIBLE = 1, 3, 0xFFFE


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a RIFF/WAVE file -> (float32 [channels, T], sample_rate)."""
    with open(path, "rb") as f:
        return decode_wav(f.read(), path)


def decode_wav(buf: bytes, path: str = "<bytes>") -> Tuple[np.ndarray, int]:
    """Decode RIFF/WAVE bytes -> (float32 [channels, T], sample_rate). The
    chunks are walked as the JAX package's native decoder walks them; the data
    chunk is clamped to the bytes present. ``path`` names the source in
    errors."""
    if len(buf) < 12 or buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError(f"{path!r} is not a RIFF/WAVE file")
    fmt = ch = sr = bits = None
    data = None
    pos = 12
    while pos + 8 <= len(buf):
        ck_id, ck_len = buf[pos:pos + 4], struct.unpack_from("<I", buf, pos + 4)[0]
        if ck_id == b"fmt " and ck_len >= 16:
            fmt, ch, sr, _, _, bits = struct.unpack_from("<HHIIHH", buf, pos + 8)
            if fmt == _EXTENSIBLE and ck_len >= 40:
                fmt = struct.unpack_from("<H", buf, pos + 32)[0]  # SubFormat GUID head
        elif ck_id == b"data":
            data = buf[pos + 8: pos + 8 + ck_len]
            break
        pos += 8 + ck_len + (ck_len & 1)
    if fmt is None or data is None or not ch:
        raise ValueError(f"{path!r}: no fmt or data chunk")
    width = bits // 8
    data = data[: len(data) // (width * ch) * width * ch] if width else data
    if fmt == _FLOAT and bits == 32:
        out = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif fmt != _PCM:
        raise ValueError(f"{path!r}: unsupported WAV format tag {fmt} ({bits}-bit)")
    elif bits == 8:
        out = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif bits == 16:
        out = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif bits == 24:
        b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
        v = (b[:, 0] << 8 | b[:, 1] << 16 | b[:, 2] << 24) >> 8  # sign-extend
        out = v.astype(np.float32) / 8388608.0
    elif bits == 32:
        out = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"{path!r}: unsupported PCM sample width: {bits} bits")
    return out.reshape(-1, ch).T.copy(), sr


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode an audio file -> (float32 [channels, T], sample_rate)."""
    if path.lower().endswith(".wav"):
        from lemas_tts_tpu_torch.native.audio import wav_decode

        with open(path, "rb") as f:
            buf = f.read()
        decoded = wav_decode(buf)
        return decoded if decoded is not None else decode_wav(buf, path)
    try:
        import soundfile as sf
    except ImportError:
        sf = None
    if sf is not None:
        data, sr = sf.read(path, dtype="float32", always_2d=True)
        return data.T.copy(), sr
    if shutil.which("ffmpeg"):
        return _read_ffmpeg(path)
    raise NotImplementedError(
        f"cannot decode {path!r}: a container other than WAV needs the 'soundfile' package "
        "or the 'ffmpeg' and 'ffprobe' programs, and neither is available")


def _read_ffmpeg(path: str) -> Tuple[np.ndarray, int]:
    """Mono float32 through ``ffmpeg``; the rate from ``ffprobe`` (24 kHz when
    it is absent or names none, as in the JAX package)."""
    proc = subprocess.run(["ffmpeg", "-v", "quiet", "-i", path, "-f", "f32le", "-ac", "1", "-"],
                          capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cannot decode audio file: {path}")
    probe = ""
    if shutil.which("ffprobe"):
        # -select_streams a:0: a container may list a video stream first,
        # whose sample_rate field is empty
        probe = subprocess.run(["ffprobe", "-v", "quiet", "-select_streams", "a:0",
                                "-show_entries", "stream=sample_rate", "-of", "csv=p=0", path],
                               capture_output=True, text=True).stdout.strip()
    rate = next((ln.strip() for ln in probe.splitlines() if ln.strip()), "")
    sr = int(rate) if rate.isdigit() else 24000
    return np.frombuffer(proc.stdout, dtype=np.float32)[None, :].copy(), sr


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Write mono/multi-channel float32 [-1,1] audio as 16-bit PCM WAV."""
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[None, :]
    pcm = np.clip(wav, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.T.tobytes())
