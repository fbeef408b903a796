"""Polyphase windowed-sinc resampling as one strided ``conv1d`` (counterpart
of ``lemas_tts_tpu/ops/resample.py``; ``torchaudio.functional.resample``
numerics: sinc_interp_hann, lowpass_filter_width=6, rolloff=0.99). The output
length is ``ceil(new/orig * T)``, which the synthesizer's bucket estimate
relies on."""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=16)
def _sinc_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                 rolloff: float = 0.99) -> tuple[np.ndarray, int]:
    """Kernel bank [new_freq, width*2 + orig_freq] and left pad width."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = (-np.arange(new_freq, dtype=np.float64) / new_freq)[:, None] + idx[None, :]
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t *= np.pi
    kernel = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
    kernel *= window
    kernel *= base_freq / orig_freq
    return kernel.astype(np.float32), width


def resample(x: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """Resample ``x [..., T]`` from ``orig_freq`` to ``new_freq`` Hz (f32)."""
    if orig_freq == new_freq:
        return x
    g = math.gcd(int(orig_freq), int(new_freq))
    o, n = orig_freq // g, new_freq // g
    kernel, width = _sinc_kernel(o, n)
    length = x.shape[-1]
    target_len = int(math.ceil(n * length / o))
    lead = x.shape[:-1]
    xf = F.pad(x.reshape(-1, 1, length).float(), (width, width + o))
    w = torch.from_numpy(kernel)[:, None, :].to(x.device)
    # exact f32 even where cuDNN would use TF32 for convolutions by default
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = F.conv1d(xf, w, stride=o)  # [B, n, T//o + 1]: one polyphase branch each
    return out.transpose(-1, -2).reshape(*lead, -1)[..., :target_len]
