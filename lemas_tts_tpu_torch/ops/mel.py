"""Log-mel frontend (counterpart of ``lemas_tts_tpu/ops/mel.py``): framed
STFT -> magnitude -> mel matmul -> ``clamp(min=1e-5).log()``, in two
variants:

- ``"vocos"``: torchaudio ``MelSpectrogram`` semantics (center=True reflect
  pad, power 1, HTK mel scale, norm None), ``T // hop + 1`` frames;
- ``"bigvgan"``: the librosa mel of the BigVGAN path (a manual reflect pad of
  ``(n_fft - hop) // 2``, center=False, ``sqrt(|S|^2 + 1e-9)``, Slaney scale
  with Slaney area norm), ``T // hop`` frames."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from lemas_tts_tpu_torch.ops.stft import stft_magnitude


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    safe_f = np.maximum(f, 1e-10)  # no log(0) warning; that branch is masked anyway
    return np.where(f >= min_log_hz, min_log_mel + np.log(safe_f / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


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


@lru_cache(maxsize=8)
def mel_filterbank_slaney(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                          f_max: float | None = None) -> np.ndarray:
    """Librosa's default mel filterbank [n_mels, n_freqs]: Slaney scale and
    Slaney area norm (``librosa.filters.mel``), computed in f64, f32 out."""
    if f_max is None:
        f_max = sample_rate / 2.0
    fftfreqs = np.linspace(0, sample_rate / 2.0, n_freqs)
    f_pts = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(f_min), _hz_to_mel_slaney(f_max),
                                          n_mels + 2))
    fdiff = np.diff(f_pts)
    ramps = f_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def vocos_mel_spectrogram(waveform: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                          win_length: int = 1024, sample_rate: int = 24000,
                          n_mels: int = 100) -> torch.Tensor:
    """Log-mel ``[..., n_mels, n_frames]`` of a ``[..., T]`` waveform."""
    mag = stft_magnitude(waveform.float(), n_fft, hop_length, win_length)
    fb = torch.from_numpy(mel_filterbank_htk(n_fft // 2 + 1, n_mels, sample_rate))
    mel = torch.matmul(fb.to(mag.device), mag)
    return torch.log(torch.clamp(mel, min=1e-5))


def bigvgan_mel_spectrogram(waveform: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                            win_length: int = 1024, sample_rate: int = 24000,
                            n_mels: int = 100) -> torch.Tensor:
    """Log-mel ``[..., n_mels, n_frames]`` of the BigVGAN path."""
    x = waveform.float()
    lead = x.shape[:-1]
    pad = (n_fft - hop_length) // 2
    x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect").reshape(*lead, -1)
    mag = stft_magnitude(x, n_fft, hop_length, win_length, center=False, eps=1e-9)
    fb = torch.from_numpy(mel_filterbank_slaney(n_fft // 2 + 1, n_mels, sample_rate))
    mel = torch.matmul(fb.to(mag.device), mag)
    return torch.log(torch.clamp(mel, min=1e-5))


MEL_SPECTROGRAMS = {"vocos": vocos_mel_spectrogram, "bigvgan": bigvgan_mel_spectrogram}


class MelFrontend:
    """Configured mel extractor: ``[..., T]`` -> ``[..., n_mels, n_frames]``."""

    def __init__(self, n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024,
                 n_mel_channels: int = 100, target_sample_rate: int = 24000,
                 mel_spec_type: str = "vocos"):
        if mel_spec_type not in MEL_SPECTROGRAMS:
            raise ValueError(f"unknown mel_spec_type: {mel_spec_type!r}")
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mel_channels = n_mel_channels
        self.target_sample_rate = target_sample_rate
        self.mel_spec_type = mel_spec_type

    def __call__(self, waveform: torch.Tensor) -> torch.Tensor:
        return MEL_SPECTROGRAMS[self.mel_spec_type](
            waveform, self.n_fft, self.hop_length, self.win_length, self.target_sample_rate,
            self.n_mel_channels)
