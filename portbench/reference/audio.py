"""Audio front end of the reference, in float64 numpy and torch.

- ``resample``: the windowed-sinc polyphase resampler that torchaudio
  defines (``sinc_interp_hann``, lowpass filter width 6, rolloff 0.99),
  evaluated as a dense product per output phase; the output has
  ``ceil(new / orig * T)`` samples;
- ``log_mel``: centred reflect-padded STFT with a periodic Hann window,
  magnitude, an HTK mel filterbank without norm, ``log(clamp(., 1e-5))``
  (torchaudio ``MelSpectrogram`` as Vocos configures it);
- ``cross_fade``: linear cross-fade of consecutive chunk waves.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rms(x: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    return float(np.sqrt(np.mean(x * x))) if x.size else 0.0


def resample(x: np.ndarray, orig: int, new: int, width_zeros: int = 6,
             rolloff: float = 0.99) -> np.ndarray:
    """``x [T]`` from ``orig`` Hz to ``new`` Hz, float64."""
    x = np.asarray(x, np.float64)
    if orig == new:
        return x
    g = math.gcd(int(orig), int(new))
    o, n = orig // g, new // g
    base = min(o, n) * rolloff
    width = math.ceil(width_zeros * o / base)
    taps = np.arange(-width, width + o, dtype=np.float64) / o
    t = (taps[None, :] - np.arange(n, dtype=np.float64)[:, None] / n) * base
    t = np.clip(t, -width_zeros, width_zeros)
    window = np.cos(t * np.pi / width_zeros / 2.0) ** 2
    arg = t * np.pi
    safe = np.where(arg == 0.0, 1.0, arg)
    kernel = np.where(arg == 0.0, 1.0, np.sin(safe) / safe) * window * (base / o)  # [n, K]
    xp = np.concatenate([np.zeros(width), x, np.zeros(width + o)])
    n_blocks = (len(xp) - kernel.shape[1]) // o + 1
    frames = np.lib.stride_tricks.sliding_window_view(xp, kernel.shape[1])[::o][:n_blocks]
    out = (frames @ kernel.T).reshape(-1)  # block k, phase p -> sample k * n + p
    return out[: int(math.ceil(n * len(x) / o))]


def htk_filterbank(n_freqs: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """Triangular filters ``[n_mels, n_freqs]`` on the HTK mel scale from 0
    to Nyquist, unnormalised."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), n_mels + 2)
    hz = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    lower = (freqs[None, :] - hz[:-2, None]) / (hz[1:-1] - hz[:-2])[:, None]
    upper = (hz[2:, None] - freqs[None, :]) / (hz[2:] - hz[1:-1])[:, None]
    return np.maximum(0.0, np.minimum(lower, upper))


def log_mel(x: np.ndarray, sample_rate: int, n_fft: int, hop: int, win: int,
            n_mels: int) -> np.ndarray:
    """``x [T]`` -> log-mel ``[T // hop + 1, n_mels]``, float64."""
    xt = torch.from_numpy(np.asarray(x, np.float64))
    window = torch.hann_window(win, periodic=True, dtype=torch.float64)
    spec = torch.stft(xt, n_fft, hop, win, window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    mag = spec.abs().numpy()  # [n_freqs, frames]
    mel = htk_filterbank(n_fft // 2 + 1, n_mels, sample_rate) @ mag
    return np.log(np.maximum(mel, 1e-5)).T


def cross_fade(waves, sample_rate: int, seconds: float) -> np.ndarray:
    """Consecutive waves joined with a linear cross-fade of ``seconds``."""
    out = np.asarray(waves[0], np.float64)
    for w in waves[1:]:
        w = np.asarray(w, np.float64)
        k = min(int(seconds * sample_rate), len(out), len(w))
        if k <= 0:
            out = np.concatenate([out, w])
            continue
        ramp = np.linspace(0.0, 1.0, k)
        out = np.concatenate([out[:-k], out[-k:] * ramp[::-1] + w[:k] * ramp, w[k:]])
    return out
