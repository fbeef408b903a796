"""ctypes bindings of the host audio DSP library (``csrc/host/audioproc.cpp``;
counterpart of ``lemas_tts_tpu/native/audio.py``).

The library builds at first use and a failed build raises (the JAX module
falls back to numpy). ``wav_decode`` returns None for a WAV the codec does
not take (8-bit PCM, a file shorter than its 44-byte header), as in the JAX
package; the caller then reads it with ``utils/audio_io.decode_wav``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from lemas_tts_tpu_torch.native import load_library

_lib = None


def _get() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("audioproc")
        # full argtypes: without them ctypes passes Python ints as 32-bit C
        # ints, which would mask int64_t lengths
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        for name, restype, argtypes in (
                ("audioproc_wav_info", ctypes.c_int,
                 [u8p, i64, ctypes.POINTER(i32), ctypes.POINTER(i32), ctypes.POINTER(i64)]),
                ("audioproc_wav_decode", ctypes.c_int, [u8p, i64, f32p]),
                ("audioproc_wav_encode", i64, [f32p, i64, i32, i32, u8p]),
                ("audioproc_resample", ctypes.c_int, [f32p, i64, i32, i32, f32p]),
                ("audioproc_resample_len", i64, [i64, i32, i32]),
                ("audioproc_scan_dbfs", i64, [f32p, i64, i32, i32, i32, f32p, i64]),
                ("audioproc_rms", ctypes.c_double, [f32p, i64]),
                ("audioproc_version", ctypes.c_char_p, [])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
    return _lib


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def version() -> str:
    return _get().audioproc_version().decode()


def wav_decode(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """WAV bytes -> ([channels, frames] float32, sample_rate); None when the
    codec does not take this WAV (8-bit PCM, a truncated header)."""
    lib = _get()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    ch, sr, frames = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    if lib.audioproc_wav_info(buf, len(data), ctypes.byref(ch), ctypes.byref(sr),
                              ctypes.byref(frames)) != 0:
        return None
    out = np.empty((ch.value, frames.value), dtype=np.float32)
    if lib.audioproc_wav_decode(buf, len(data), _f32(out)) != 0:
        return None
    return out, sr.value


def wav_encode(x: np.ndarray, sample_rate: int) -> bytes:
    """[T] or [channels, T] float32 -> PCM16 WAV bytes."""
    lib = _get()
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[None]
    channels, frames = x.shape
    total = lib.audioproc_wav_encode(_f32(x), frames, channels, sample_rate, None)
    out = (ctypes.c_uint8 * total)()
    lib.audioproc_wav_encode(_f32(x), frames, channels, sample_rate, out)
    return bytes(out)


def resample(x: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """1-D windowed-sinc resample (torchaudio's ``sinc_interp_hann``,
    ``ops/resample.py``'s numerics) on the host."""
    lib = _get()
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(lib.audioproc_resample_len(x.shape[-1], orig_freq, new_freq), np.float32)
    if lib.audioproc_resample(_f32(x), x.shape[-1], orig_freq, new_freq, _f32(out)) != 0:
        raise RuntimeError(f"audioproc_resample {orig_freq} -> {new_freq} failed")
    return out


def scan_dbfs(x: np.ndarray, sr: int, win_ms: int, seek_ms: int) -> np.ndarray:
    """Sliding-window dBFS profile, one value per ``seek_ms`` start (the
    silence scan's hot loop)."""
    lib = _get()
    x = np.ascontiguousarray(x, dtype=np.float32)
    cap = max(1, (x.shape[-1] * 1000) // (sr * seek_ms) + 2)
    out = np.empty(cap, dtype=np.float32)
    n = lib.audioproc_scan_dbfs(_f32(x), x.shape[-1], sr, win_ms, seek_ms, _f32(out), cap)
    return out[:n]


def rms(x: np.ndarray) -> float:
    x = np.ascontiguousarray(x, dtype=np.float32)
    return float(_get().audioproc_rms(_f32(x), x.shape[-1]))
