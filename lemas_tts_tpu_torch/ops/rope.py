"""Rotary and absolute position embeddings (counterpart of
``lemas_tts_tpu/ops/rope.py``), x_transformers-compatible: ``angles`` are
per-pair rotation angles and pairs ``(x0, x1)`` are interleaved, rotated as
``(x0, x1) -> (-x1, x0)``."""

from __future__ import annotations

import numpy as np
import torch


_ANGLES: dict = {}


def rope_angles(seq_len: int, dim: int, theta: float = 10000.0,
                device=None) -> torch.Tensor:
    """Per-position, per-pair rotation angles [seq_len, dim//2] (float32).
    Built once per (shape, device) and shared by every caller, who must not
    write to it: a forward inside a CUDA graph capture copies nothing from
    the host."""
    key = (seq_len, dim, theta, str(torch.device(device or "cpu")))
    angles = _ANGLES.get(key)
    if angles is None:
        inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
        t = np.arange(seq_len, dtype=np.float32)
        angles = torch.from_numpy(np.outer(t, inv_freq).astype(np.float32)).to(device)
        _ANGLES[key] = angles
    return angles


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [..., seq, dim]`` by ``angles [seq, dim//2]`` (interleaved
    pairs), computed in f32 and cast back to ``x.dtype``."""
    xf = x.float()
    even, odd = xf[..., 0::2], xf[..., 1::2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    out = torch.stack([even * cos - odd * sin, odd * cos + even * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def abs_pos_embedding(dim: int, max_pos: int, theta: float = 10000.0) -> np.ndarray:
    """Absolute sinusoidal table [max_pos, dim] = concat(cos, sin) halves
    (reference ``precompute_freqs_cis``)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32)[: dim // 2] / dim))
    t = np.arange(max_pos, dtype=np.float32)
    f = np.outer(t, freqs)
    return np.concatenate([np.cos(f), np.sin(f)], axis=-1).astype(np.float32)
