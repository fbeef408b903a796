"""Host-side WAV file IO with numpy only (counterpart of
``lemas_tts_tpu/utils/audio_io.py``): 8-, 16-, 24- and 32-bit PCM and
IEEE float32 WAV, as the JAX package's native decoder
(``native/audioproc.cpp``) reads them. Other containers (the JAX package's
``soundfile``/``ffmpeg`` fallbacks) are not ported and raise."""

from __future__ import annotations

import os
import struct
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
    """Decode an audio file -> (float32 [channels, T], sample_rate). Only WAV
    is supported in this port."""
    if not path.lower().endswith(".wav"):
        raise NotImplementedError(
            f"cannot decode {path!r}: only WAV files (PCM or float32) are supported")
    return read_wav(path)


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
