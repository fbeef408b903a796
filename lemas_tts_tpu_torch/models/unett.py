"""UNet-Transformer backbone of E2-TTS (counterpart of
``lemas_tts_tpu/models/unett.py``).

A flat transformer whose first half pushes its activations on a skip stack
and whose second half pops them back (``concat``: concat and a bias-free
projection, ``add``, or ``none``), with pre-norm RMSNorm blocks (no AdaLN)
and the time embedding packed as token 0: the mask is padded with True there
and rope runs at N + 1. Attention is the port's ``Attention`` (split heads,
rope on the first ``pe_attn_head`` heads, the split-head ``attention`` of
the model's ``attn_backend``: K5 at any N under ``"vmem"``, so at the ragged
N + 1 too, and K5 there under ``"splash"`` as well, since JAX hands such N
to its XLA ``sdpa``). Parameter names are the reference F5-TTS
``unett.py``'s (``layers.{i}.0`` skip_proj, ``.1`` attn_norm, ``.2`` attn,
``.3`` ff_norm, ``.4`` ff), and ``embed_text`` keeps the DiT's sampler
contract. Prosody text is refused, as in JAX: only the DiT consumes it.
"""

from __future__ import annotations

import torch
from torch import nn

from lemas_tts_tpu_torch.config import DiTArch
from lemas_tts_tpu_torch.models.dit import InputEmbedding, TextEmbedding
from lemas_tts_tpu_torch.models.modules import (Attention, FeedForward, RMSNorm,
                                                TimestepEmbedding, dense)
from lemas_tts_tpu_torch.ops.rope import rope_angles

SKIP_TYPES = ("concat", "add", "none")


class UNetT(nn.Module):
    """CFM velocity transformer: v = UNetT(x_t, cond, text, t). Of ``arch`` it
    reads dim, depth (even), heads, dim_head, ff_mult, text_dim,
    text_mask_padding, qk_norm, conv_layers and pe_attn_head."""

    def __init__(self, arch: DiTArch, mel_dim: int = 100, text_num_embeds: int = 256,
                 compute_dtype: torch.dtype = torch.float32, skip_connect_type: str = "concat",
                 attn_backend: str = "vmem"):
        super().__init__()
        if arch.depth % 2:
            raise ValueError(f"UNet-Transformer depth must be even, got {arch.depth}")
        if skip_connect_type not in SKIP_TYPES:
            raise ValueError(f"unknown skip_connect_type: {skip_connect_type!r}")
        self.dim_head = arch.dim_head
        self.compute_dtype = compute_dtype
        self.skip_connect_type = skip_connect_type
        text_dim = arch.text_dim if arch.text_dim is not None else mel_dim
        self.time_embed = TimestepEmbedding(arch.dim)
        self.text_embed = TextEmbedding(text_num_embeds, text_dim,
                                        mask_padding=arch.text_mask_padding,
                                        conv_layers=arch.conv_layers, conv_mult=arch.conv_mult)
        self.input_embed = InputEmbedding(mel_dim, text_dim, arch.dim)
        self.layers = nn.ModuleList()
        for idx in range(arch.depth):
            later = idx >= arch.depth // 2
            self.layers.append(nn.ModuleList([
                nn.Linear(arch.dim * 2, arch.dim, bias=False)
                if skip_connect_type == "concat" and later else None,
                RMSNorm(arch.dim),
                Attention(arch.dim, arch.heads, arch.dim_head, arch.qk_norm, arch.pe_attn_head,
                          attn_backend),
                RMSNorm(arch.dim),
                FeedForward(arch.dim, arch.ff_mult)]))
        self.norm_out = RMSNorm(arch.dim)
        self.proj_out = nn.Linear(arch.dim, mel_dim)

    def embed_text(self, text_ids: torch.Tensor, seq_len: int, drop_text: bool = False):
        """Text embedding [B, seq_len, text_dim], computed once per utterance."""
        return self.text_embed(text_ids, seq_len, drop_text=drop_text, dtype=self.compute_dtype)

    def forward(self, x, cond, text_ids, time, mask=None, drop_text: bool = False,
                text_embed=None, prosody_text=None):
        """Velocity [B, N, mel_dim] (f32); ``mask`` [B, N] marks the valid
        frames."""
        if prosody_text is not None:
            raise NotImplementedError("UNetT does not take prosody_text conditioning; the "
                                      "prosody models use the DiT backbone")
        B, N, _ = x.shape
        if time.ndim == 0:
            time = time.expand(B)
        t_emb = self.time_embed(time, self.compute_dtype)
        if text_embed is None:
            text_embed = self.embed_text(text_ids, N, drop_text=drop_text)
        h = self.input_embed(x.to(self.compute_dtype), cond.to(self.compute_dtype), text_embed)
        h = torch.cat([t_emb[:, None, :].to(h.dtype), h], dim=1)  # time as token 0
        if mask is not None:
            mask = nn.functional.pad(mask, (1, 0), value=True)
        angles = rope_angles(N + 1, self.dim_head, device=x.device)
        depth = len(self.layers)
        skips = []
        for idx, (skip_proj, attn_norm, attn, ff_norm, ff) in enumerate(self.layers):
            if idx < depth // 2:
                skips.append(h)
            else:
                skip = skips.pop()
                if self.skip_connect_type == "concat":
                    h = dense(torch.cat([h, skip], dim=-1), skip_proj)
                elif self.skip_connect_type == "add":
                    h = h + skip
            h = attn(attn_norm(h), mask=mask, angles=angles) + h
            h = ff(ff_norm(h)) + h
        return dense(self.norm_out(h)[:, 1:], self.proj_out).float()
