"""Host-side WAV file IO with the standard library only (the stdlib part of
``lemas_tts_tpu/utils/audio_io.py``; native and ffmpeg decoding are not
ported)."""

from __future__ import annotations

import os
import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a PCM WAV file -> (float32 [channels, T], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        sw = w.getsampwidth()
        raw = w.readframes(n)
    if sw == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported PCM sample width: {sw}")
    if ch > 1:
        data = data.reshape(-1, ch).T  # [ch, T]
    else:
        data = data[None, :]
    return data, sr


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode an audio file -> (float32 [channels, T], sample_rate). Only PCM
    WAV is supported in this port."""
    if not path.lower().endswith(".wav"):
        raise NotImplementedError(
            f"cannot decode {path!r}: only PCM WAV files are supported")
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
