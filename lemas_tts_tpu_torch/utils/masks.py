"""Mask helpers (counterpart of ``lemas_tts_tpu/utils/masks.py``). Random
draws take an explicit ``torch.Generator``, or the uniforms themselves."""

from __future__ import annotations

from typing import Optional

import torch


def lens_to_mask(lens: torch.Tensor, length: int) -> torch.Tensor:
    """[B] lengths -> [B, length] bool mask (True inside each sequence)."""
    seq = torch.arange(length, device=lens.device, dtype=lens.dtype)
    return seq[None, :] < lens[:, None]


def mask_from_start_end_indices(length: int, start: torch.Tensor,
                                end: torch.Tensor) -> torch.Tensor:
    """[B] start/end -> [B, length] bool mask, True on [start, end)."""
    seq = torch.arange(length, device=start.device, dtype=start.dtype)
    return (seq[None, :] >= start[:, None]) & (seq[None, :] < end[:, None])


def mask_from_frac_lengths(seq_len: torch.Tensor, frac_lengths: torch.Tensor, length: int,
                           generator: Optional[torch.Generator] = None,
                           rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Random contiguous span covering ``frac`` of each sequence (the
    training span-infill mask). ``rand`` [B] in [0, 1) places each span;
    drawn from ``generator`` when not given."""
    span = (frac_lengths * seq_len).to(torch.int32)
    max_start = seq_len.to(torch.int32) - span
    if rand is None:
        rand = torch.rand(frac_lengths.shape, generator=generator, device=frac_lengths.device)
    start = torch.clamp((max_start * rand).to(torch.int32), min=0)
    return mask_from_start_end_indices(length, start, start + span)
