"""Vocos mel vocoder: ConvNeXt backbone + iSTFT head (counterpart of
``lemas_tts_tpu/models/vocos.py``). Parameter names follow the published
``charactr/vocos-mel-24khz`` checkpoint (``backbone.*``, ``head.out.*``).

``decode`` takes a frame mask and zeroes the padded frames after every block
and in the spectrum, and the iSTFT leaves them out of its envelope, so a
bucket-padded batch decode equals per-sample exact-length decodes.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lemas_tts_tpu_torch.models.modules import conv1d, dense, layer_norm_f32
from lemas_tts_tpu_torch.ops.stft import istft


class VocosConvNeXtBlock(nn.Module):
    """ConvNeXt-v1 block: dwconv k=7 -> LN -> pw -> GELU -> pw -> layer-scale
    gamma, residual."""

    def __init__(self, dim: int, intermediate_dim: int):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:  # [B, T, C]
        h = conv1d(x.to(dtype), self.dwconv, (3, 3))
        h = layer_norm_f32(h, self.norm).to(dtype)
        h = dense(F.gelu(dense(h, self.pwconv1)), self.pwconv2)
        return x + self.gamma * h  # f32 layer scale promotes, as in the JAX module


class VocosBackbone(nn.Module):
    def __init__(self, input_channels: int = 100, dim: int = 512,
                 intermediate_dim: int = 1536, num_layers: int = 8):
        super().__init__()
        self.embed = nn.Conv1d(input_channels, dim, 7)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.convnext = nn.ModuleList(
            [VocosConvNeXtBlock(dim, intermediate_dim) for _ in range(num_layers)])
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, mel, frame_mask, dtype):
        def m(x):
            return x if frame_mask is None else torch.where(frame_mask[..., None], x, 0.0)

        x = m(mel.transpose(1, 2).to(dtype))  # [B, T, n_mels]
        x = conv1d(x, self.embed, (3, 3))
        x = layer_norm_f32(x, self.norm).to(dtype)
        for blk in self.convnext:
            x = blk(m(x), dtype)
        return layer_norm_f32(m(x), self.final_layer_norm).to(dtype)


class VocosHead(nn.Module):
    def __init__(self, dim: int, n_fft: int):
        super().__init__()
        self.out = nn.Linear(dim, n_fft + 2)


class Vocos(nn.Module):
    """``decode``: [B, n_mels, T] log-mel -> [B, (T-1)*hop] wave."""

    def __init__(self, input_channels: int = 100, dim: int = 512, intermediate_dim: int = 1536,
                 num_layers: int = 8, n_fft: int = 1024, hop_length: int = 256,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_fft, self.hop_length, self.compute_dtype = n_fft, hop_length, compute_dtype
        self.backbone = VocosBackbone(input_channels, dim, intermediate_dim, num_layers)
        self.head = VocosHead(dim, n_fft)

    def wave_length(self, n_frames: int) -> int:
        """Samples a decode of ``n_frames`` frames gives (the iSTFT head)."""
        return (n_frames - 1) * self.hop_length

    def decode(self, mel: torch.Tensor, frame_mask: Optional[torch.Tensor] = None):
        h = self.backbone(mel, frame_mask, self.compute_dtype)
        h = dense(h, self.head.out).float().transpose(1, 2)  # [B, n_fft+2, T]
        n_bins = self.n_fft // 2 + 1
        # Vocos' ISTFTHead order: clip AFTER exp (caps the magnitude at 1e2)
        mag = torch.clamp(torch.exp(h[:, :n_bins]), max=1e2)
        phase = h[:, n_bins:]
        spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
        if frame_mask is not None:
            spec = torch.where(frame_mask[:, None, :], spec, 0)
        return istft(spec, self.n_fft, self.hop_length, frame_mask=frame_mask)

    forward = decode


def convert_vocos(sd: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """charactr/vocos ``pytorch_model.bin`` state dict (numpy) -> the JAX
    ``Vocos``'s param tree, leaf for leaf what
    ``lemas_tts_tpu/models/vocos.py:convert_vocos`` gives
    (``scripts/convert_checkpoint.py --vocos``)."""

    def lin(p):
        return {"kernel": np.asarray(sd[f"{p}.weight"]).T, "bias": np.asarray(sd[f"{p}.bias"])}

    def conv(p):
        return {"kernel": np.transpose(np.asarray(sd[f"{p}.weight"]), (2, 1, 0)),
                "bias": np.asarray(sd[f"{p}.bias"])}

    def ln(p):
        return {"scale": np.asarray(sd[f"{p}.weight"]), "bias": np.asarray(sd[f"{p}.bias"])}

    bb: Dict[str, Any] = {"embed": conv("backbone.embed"), "norm": ln("backbone.norm"),
                          "final_layer_norm": ln("backbone.final_layer_norm")}
    i = 0
    while f"backbone.convnext.{i}.dwconv.weight" in sd:
        key = f"backbone.convnext.{i}"
        bb[f"convnext_{i}"] = {"dwconv": conv(f"{key}.dwconv"), "norm": ln(f"{key}.norm"),
                               "pwconv1": lin(f"{key}.pwconv1"),
                               "pwconv2": lin(f"{key}.pwconv2"),
                               "gamma": np.asarray(sd[f"{key}.gamma"])}
        i += 1
    return {"backbone": bb, "out": lin("head.out")}
