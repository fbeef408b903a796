"""Framed STFT / iSTFT (counterpart of ``lemas_tts_tpu/ops/stft.py``).

``torch.istft`` takes no frame mask, so the inverse is written out here: the
inverse rFFT of each frame, the window, and an overlap-add of the frames and
of the squared-window envelope with ``F.fold``. With ``frame_mask``, padded
frames are left out of both the signal and the envelope, so a bucket-padded
batch decode equals an exact-length decode on the valid prefix.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


_WINDOWS: dict = {}


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window, as ``torch.hann_window(N)``, computed in f64 and
    rounded to f32 like the JAX package's. Made once per (length, device) and
    shared by every caller, who must not write to it: a copy from the host
    per call would wait for the card to finish the work queued before it."""
    key = (win_length, str(torch.device(device or "cpu")))
    w = _WINDOWS.get(key)
    if w is None:
        n = np.arange(win_length)
        w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
        w = _WINDOWS[key] = torch.from_numpy(w.astype(np.float32)).to(device)
    return w


def stft(x, n_fft: int, hop_length: int, win_length=None, center: bool = True) -> torch.Tensor:
    """Complex STFT of ``x [..., T]`` -> ``[..., n_fft//2+1, n_frames]``
    (``torch.stft(pad_mode="reflect", onesided=True)`` semantics, periodic
    Hann window of ``win_length`` centred in ``n_fft``; ``center`` reflect-pads
    ``n_fft // 2`` on both ends)."""
    if win_length is None:
        win_length = n_fft
    window = hann_window(win_length, device=x.device).to(x.dtype)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    lead = x.shape[:-1]
    x = x.reshape(-1, 1, x.shape[-1])
    if center:
        x = F.pad(x, (n_fft // 2, n_fft // 2), mode="reflect")
    frames = x[:, 0].unfold(-1, n_fft, hop_length) * window  # [B, n_frames, n_fft]
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return spec.transpose(-1, -2).reshape(*lead, n_fft // 2 + 1, -1)


def stft_magnitude(x, n_fft: int, hop_length: int, win_length=None, center: bool = True,
                   eps: float = 0.0) -> torch.Tensor:
    """``|STFT|``; ``eps`` gives the BigVGAN mel's ``sqrt(re^2 + im^2 + eps)``."""
    spec = stft(x, n_fft, hop_length, win_length, center)
    power = spec.real ** 2 + spec.imag ** 2
    return torch.sqrt(power + eps) if eps else torch.sqrt(power)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    # frames [B, n_frames, n_fft] -> [B, n_fft + hop*(n_frames-1)]
    B, n_frames, n_fft = frames.shape
    out_len = n_fft + hop_length * (n_frames - 1)
    out = F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                 kernel_size=(1, n_fft), stride=(1, hop_length))
    return out.reshape(B, out_len)


def istft(spec, n_fft: int, hop_length: int, frame_mask=None,
          eps: float = 1e-11) -> torch.Tensor:
    """Inverse STFT of a complex spectrogram ``[B, n_bins, n_frames]``:
    Hann-windowed overlap-add normalised by the summed squared window,
    trimmed by ``n_fft//2`` on both ends (``torch.istft(center=True)``).
    ``frame_mask [B, n_frames]`` marks the valid frames."""
    window = hann_window(n_fft, device=spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    B, n_frames, _ = frames.shape
    wsq = (window * window).expand(B, n_frames, n_fft)
    if frame_mask is not None:
        keep = frame_mask[..., None]
        frames = torch.where(keep, frames, 0.0)
        wsq = torch.where(keep, wsq, 0.0)
    out = _overlap_add(frames, hop_length) / torch.clamp(
        _overlap_add(wsq.contiguous(), hop_length), min=eps)
    half = n_fft // 2
    return out[..., half:-half]
