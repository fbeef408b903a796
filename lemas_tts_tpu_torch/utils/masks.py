"""Mask helpers (counterpart of ``lemas_tts_tpu/utils/masks.py``)."""

from __future__ import annotations

import torch


def lens_to_mask(lens: torch.Tensor, length: int) -> torch.Tensor:
    """[B] lengths -> [B, length] bool mask (True inside each sequence)."""
    seq = torch.arange(length, device=lens.device, dtype=lens.dtype)
    return seq[None, :] < lens[:, None]
