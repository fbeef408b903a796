"""Log-mel frontend (counterpart of ``lemas_tts_tpu/ops/mel.py``, vocos
variant): reflect pad -> framed STFT -> magnitude -> HTK mel matmul ->
``clamp(min=1e-5).log()`` (torchaudio ``MelSpectrogram`` semantics,
center=True, power=1, norm=None). The BigVGAN variant is not ported."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lemas_tts_tpu_torch.ops.stft import stft_magnitude


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@lru_cache(maxsize=8)
def mel_filterbank_htk(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                       f_max: float | None = None) -> np.ndarray:
    """Triangular filterbank [n_mels, n_freqs], HTK scale, no norm (float32,
    as ``torchaudio.functional.melscale_fbanks(mel_scale="htk")``)."""
    if f_max is None:
        f_max = sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs, dtype=np.float32)
    m_min, m_max = _hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max)
    m_pts = np.linspace(m_min, m_max, n_mels + 2, dtype=np.float32)
    f_pts = _mel_to_hz_htk(m_pts).astype(np.float32)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up)).astype(np.float32)
    return fb.T.copy()


def vocos_mel_spectrogram(waveform: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                          win_length: int = 1024, sample_rate: int = 24000,
                          n_mels: int = 100) -> torch.Tensor:
    """Log-mel ``[..., n_mels, n_frames]`` of a ``[..., T]`` waveform."""
    mag = stft_magnitude(waveform.float(), n_fft, hop_length, win_length)
    fb = torch.from_numpy(mel_filterbank_htk(n_fft // 2 + 1, n_mels, sample_rate))
    mel = torch.matmul(fb.to(mag.device), mag)
    return torch.log(torch.clamp(mel, min=1e-5))


class MelFrontend:
    """Configured mel extractor: ``[..., T]`` -> ``[..., n_mels, n_frames]``."""

    def __init__(self, n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024,
                 n_mel_channels: int = 100, target_sample_rate: int = 24000,
                 mel_spec_type: str = "vocos"):
        if mel_spec_type != "vocos":
            raise NotImplementedError(
                f"mel_spec_type={mel_spec_type!r}: only the vocos mel is ported")
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mel_channels = n_mel_channels
        self.target_sample_rate = target_sample_rate
        self.mel_spec_type = mel_spec_type

    def __call__(self, waveform: torch.Tensor) -> torch.Tensor:
        return vocos_mel_spectrogram(waveform, self.n_fft, self.hop_length, self.win_length,
                                     self.target_sample_rate, self.n_mel_channels)
