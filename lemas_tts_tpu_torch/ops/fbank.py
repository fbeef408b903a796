"""Kaldi-compatible log-mel FBANK features (counterpart of
``lemas_tts_tpu/ops/fbank.py``).

``torchaudio.compliance.kaldi.fbank`` at the defaults the prosody path uses
(80 bins, 16 kHz): 25 ms povey window, 10 ms shift, snip-edges framing, FFT
padded to the next power of two, no dither, DC-offset removal, pre-emphasis
0.97 against the previous sample (the first sample repeated), power
spectrum over the first ``padded // 2`` bins (the Nyquist bin dropped), Kaldi
mel banks (20 Hz to Nyquist), natural log with an f32-eps floor. The frames
run on the caller's tensor and device, in f32; the filterbank and the window
are made in numpy and copied to each device once.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

EPSILON = float(np.finfo(np.float32).eps)  # torchaudio kaldi log floor (f32)
MIN_SAMPLES = 400  # one 25 ms frame at 16 kHz


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


@lru_cache(maxsize=8)
def kaldi_mel_banks(num_bins: int = 80, window_size_padded: int = 512,
                    sample_rate: int = 16000, low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """Triangular mel filterbank, Kaldi layout ``[num_bins, padded // 2]``
    (the Nyquist bin excluded), f32."""
    n_fft_bins = window_size_padded // 2
    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    fft_bin_width = sample_rate / window_size_padded
    mel_low, mel_high = _mel(low_freq), _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    mels = _mel(fft_bin_width * np.arange(n_fft_bins))
    bins = np.zeros((num_bins, n_fft_bins), dtype=np.float64)
    for b in range(num_bins):
        left, center, right = (mel_low + b * mel_delta, mel_low + (b + 1) * mel_delta,
                               mel_low + (b + 2) * mel_delta)
        up = (mels - left) / (center - left)
        down = (right - mels) / (right - center)
        bins[b] = np.clip(np.minimum(up, down), 0.0, None)
    return bins.astype(np.float32)


@lru_cache(maxsize=8)
def _povey_window(n: int) -> np.ndarray:
    a = 2 * math.pi / (n - 1)
    return ((0.5 - 0.5 * np.cos(a * np.arange(n))) ** 0.85).astype(np.float32)


_ON_DEVICE: dict = {}


def _on_device(key: tuple, make, device) -> torch.Tensor:
    """``make()``'s numpy constant on ``device``, copied there once."""
    k = key + (str(device),)
    t = _ON_DEVICE.get(k)
    if t is None:
        t = _ON_DEVICE[k] = torch.from_numpy(make()).to(device)
    return t


def kaldi_fbank(waveform: torch.Tensor, num_mel_bins: int = 80, sample_rate: int = 16000,
                frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
                preemphasis: float = 0.97, remove_dc_offset: bool = True) -> torch.Tensor:
    """``[T]`` -> ``[frames, num_mel_bins]`` log-fbank (``[B, T]`` ->
    ``[B, frames, bins]``). Float input is not rescaled to int16 range, as in
    torchaudio and the reference, which feed [-1, 1] audio."""
    squeeze = waveform.dim() == 1
    x = (waveform[None] if squeeze else waveform).float()
    window_size = int(sample_rate * frame_length_ms / 1000)  # 400
    window_shift = int(sample_rate * frame_shift_ms / 1000)  # 160
    padded = 1 << (window_size - 1).bit_length()  # 512
    frames = x.unfold(-1, window_size, window_shift)  # snip edges: [B, F, window]
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    frames = frames * _on_device(("povey", window_size), lambda: _povey_window(window_size),
                                 x.device)
    power = torch.abs(torch.fft.rfft(frames, n=padded, dim=-1)[..., : padded // 2]) ** 2
    banks = _on_device(("banks", num_mel_bins, padded, sample_rate),
                       lambda: kaldi_mel_banks(num_mel_bins, padded, sample_rate), x.device)
    out = torch.log(torch.clamp(torch.matmul(power, banks.t()), min=EPSILON))
    return out[0] if squeeze else out


def extract_fbank_16k(audio_16k: torch.Tensor) -> torch.Tensor:
    """80-bin fbank ``[frames, 80]`` of 16 kHz mono audio (the first row of a
    2-D input), with the reference's guard: audio shorter than one frame is
    tiled until it holds one."""
    x = audio_16k.float()
    if x.dim() == 2:
        x = x[0]
    if x.shape[-1] < MIN_SAMPLES:
        x = x.repeat(MIN_SAMPLES // max(1, x.shape[-1]) + 1)
    return kaldi_fbank(x)
