"""Pretssel prosody encoder: ECAPA-TDNN (counterpart of
``lemas_tts_tpu/models/prosody.py``).

80-bin kaldi FBANK at 16 kHz (``ops/fbank.py``) -> TDNN stem -> (n - 2)
SE-Res2Net blocks -> concat of their outputs -> MFA TDNN -> attentive
statistics pooling (with global context) -> LayerNorm -> 1x1 conv to
``embed_dim`` -> L2 normalise. Channel-last ``[B, T, C]`` as in the JAX
module; the parameter names are the reference's (``blocks.0.conv``,
``blocks.1.se_block.conv1``, ``blocks.1.res2net_block.blocks.0``,
``mfa``, ``asp.tdnn``, ``asp.conv``, ``asp_norm``, ``fc``), so a reference
state dict loads with ``load_state_dict`` after ``remap_prosody_state_dict``.

Numerics kept from the JAX module: LayerNorm eps 1e-12 in f32 (one
``F.layer_norm``: the reference's two-pass variance, where flax takes the
mean of squares; the two agree to f32 rounding), the SE and pooling means
over a frame count clamped to >= 1, ``sqrt(clip(var, 1e-12))``, a masked
softmax with the finite -1e30 (a row whose frames are all masked stays
finite), ``F.normalize`` with eps 1e-12. The encoder runs in f32 whatever
the DiT's dtype, once per request.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lemas_tts_tpu_torch.ops.fbank import extract_fbank_16k

LN_EPS = 1e-12
MASKED_SCORE = -1e30  # finite: -inf on a fully-masked row makes the softmax NaN


@dataclass(frozen=True)
class ECAPAConfig:
    """Pretssel prosody-encoder hyper-parameters (cfg JSON ``model`` keys)."""

    channels: Tuple[int, ...] = (512, 512, 512, 512, 1536)
    kernel_sizes: Tuple[int, ...] = (5, 3, 3, 3, 1)
    dilations: Tuple[int, ...] = (1, 2, 3, 4, 1)
    attention_channels: int = 128
    res2net_scale: int = 8
    se_channels: int = 128
    global_context: bool = True
    groups: Tuple[int, ...] = (1, 1, 1, 1, 1)
    embed_dim: int = 512
    input_dim: int = 80

    @classmethod
    def from_pretssel_json(cls, cfg_path) -> "ECAPAConfig":
        m = json.loads(Path(cfg_path).read_text())["model"]
        return cls(channels=tuple(m["prosody_channels"]),
                   kernel_sizes=tuple(m["prosody_kernel_sizes"]),
                   dilations=tuple(m["prosody_dilations"]),
                   attention_channels=m["prosody_attention_channels"],
                   res2net_scale=m["prosody_res2net_scale"],
                   se_channels=m["prosody_se_channels"],
                   global_context=m["prosody_global_context"],
                   groups=tuple(m["prosody_groups"]),
                   embed_dim=m["prosody_embed_dim"],
                   input_dim=m["input_feat_per_channel"])


def _conv(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """Channel-last conv, symmetric ``dilation * (k - 1) // 2`` zero padding."""
    pad = conv.dilation[0] * (conv.kernel_size[0] - 1) // 2
    return F.conv1d(x.transpose(1, 2), conv.weight, conv.bias, padding=pad,
                    dilation=conv.dilation, groups=conv.groups).transpose(1, 2)


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, LN_EPS)


def _masked_mean(x: torch.Tensor, m: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over time ``[B, 1, C]``; ``m [B, T, 1]`` weights the frames, over
    a count clamped to >= 1."""
    if m is None:
        return x.mean(dim=1, keepdim=True)
    return (x * m).sum(dim=1, keepdim=True) / torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)


class TDNNBlock(nn.Module):
    """conv1d -> ReLU -> LayerNorm over channels."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size, dilation=dilation,
                              groups=groups)
        self.norm = nn.LayerNorm(out_channels, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, C]
        return _layer_norm(F.relu(_conv(x, self.conv)), self.norm)


class Res2NetBlock(nn.Module):
    """Channels split into ``scale`` groups; group 0 passes through, group i
    goes through a TDNN over ``x_i + y_{i-1}`` (group 1 over ``x_1``)."""

    def __init__(self, channels: int, scale: int = 8, kernel_size: int = 3,
                 dilation: int = 1):
        super().__init__()
        self.scale = scale
        hidden = channels // scale
        self.blocks = nn.ModuleList([TDNNBlock(hidden, hidden, kernel_size, dilation)
                                     for _ in range(scale - 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = []
        for i, x_i in enumerate(torch.chunk(x, self.scale, dim=-1)):
            if i == 0:
                y = x_i
            elif i == 1:
                y = self.blocks[0](x_i)
            else:
                y = self.blocks[i - 1](x_i + y)
            ys.append(y)
        return torch.cat(ys, dim=-1)


class SEBlock(nn.Module):
    """Squeeze-and-excitation over time, the mean masked by the frames."""

    def __init__(self, in_channels: int, se_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv1d(in_channels, se_channels, 1)
        self.conv2 = nn.Conv1d(se_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, m: Optional[torch.Tensor] = None) -> torch.Tensor:
        s = F.relu(_conv(_masked_mean(x, m), self.conv1))
        return torch.sigmoid(_conv(s, self.conv2)) * x


class AttentiveStatisticsPooling(nn.Module):
    """Attention-weighted mean and std over time, with the global mean and
    std as context: ``[B, T, C]`` -> ``[B, 1, 2C]``."""

    def __init__(self, channels: int, attention_channels: int = 128,
                 global_context: bool = True):
        super().__init__()
        self.global_context = global_context
        self.tdnn = TDNNBlock(channels * 3 if global_context else channels,
                              attention_channels, 1)
        self.conv = nn.Conv1d(attention_channels, channels, 1)

    @staticmethod
    def _stats(x: torch.Tensor, w: torch.Tensor):
        mean = (w * x).sum(dim=1)  # [B, C]
        var = (w * torch.square(x - mean[:, None, :])).sum(dim=1)
        return mean, torch.sqrt(torch.clamp(var, min=LN_EPS))

    def forward(self, x: torch.Tensor, m: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, C = x.shape
        if m is None:
            m = torch.ones(B, T, 1, dtype=x.dtype, device=x.device)
        if self.global_context:
            mean, std = self._stats(x, m / torch.clamp(m.sum(dim=1, keepdim=True), min=1.0))
            attn_in = torch.cat([x, mean[:, None, :].expand(B, T, C),
                                 std[:, None, :].expand(B, T, C)], dim=-1)
        else:
            attn_in = x
        attn = _conv(torch.tanh(self.tdnn(attn_in)), self.conv)
        attn = torch.softmax(torch.where(m == 0, MASKED_SCORE, attn), dim=1)
        mean, std = self._stats(x, attn)
        return torch.cat([mean, std], dim=-1)[:, None, :]


class SERes2NetBlock(nn.Module):
    """1x1 TDNN -> Res2Net -> 1x1 TDNN -> SE, plus the residual (a 1x1
    ``shortcut`` conv when the widths differ)."""

    def __init__(self, in_channels: int, out_channels: int, res2net_scale: int = 8,
                 se_channels: int = 128, kernel_size: int = 1, dilation: int = 1,
                 groups: int = 1):
        super().__init__()
        self.tdnn1 = TDNNBlock(in_channels, out_channels, 1, 1, groups)
        self.res2net_block = Res2NetBlock(out_channels, res2net_scale, kernel_size, dilation)
        self.tdnn2 = TDNNBlock(out_channels, out_channels, 1, 1, groups)
        self.se_block = SEBlock(out_channels, se_channels, out_channels)
        self.shortcut = (nn.Conv1d(in_channels, out_channels, 1)
                         if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, m: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = x if self.shortcut is None else _conv(x, self.shortcut)
        h = self.tdnn2(self.res2net_block(self.tdnn1(x)))
        return self.se_block(h, m) + residual


class ECAPA_TDNN(nn.Module):
    """``[B, T, input_dim]`` fbank (``frame_mask [B, T]`` bool, True = a
    valid frame) -> ``[B, embed_dim]`` L2-normalised embedding."""

    def __init__(self, cfg: ECAPAConfig = ECAPAConfig()):
        super().__init__()
        c = self.cfg = cfg
        blocks = [TDNNBlock(c.input_dim, c.channels[0], c.kernel_sizes[0], c.dilations[0],
                            c.groups[0])]
        for i in range(1, len(c.channels) - 1):
            blocks.append(SERes2NetBlock(c.channels[i - 1], c.channels[i], c.res2net_scale,
                                         c.se_channels, c.kernel_sizes[i], c.dilations[i],
                                         c.groups[i]))
        self.blocks = nn.ModuleList(blocks)
        self.mfa = TDNNBlock(sum(c.channels[1:-1]), c.channels[-1], c.kernel_sizes[-1],
                             c.dilations[-1], c.groups[-1])
        self.asp = AttentiveStatisticsPooling(c.channels[-1], c.attention_channels,
                                              c.global_context)
        self.asp_norm = nn.LayerNorm(c.channels[-1] * 2, eps=LN_EPS)
        self.fc = nn.Conv1d(c.channels[-1] * 2, c.embed_dim, 1)

    def forward(self, x: torch.Tensor, frame_mask: Optional[torch.Tensor] = None):
        m = None if frame_mask is None else frame_mask[..., None].to(x.dtype)
        h = self.blocks[0](x)
        feats = []
        for blk in self.blocks[1:]:
            h = blk(h, m)
            feats.append(h)
        h = self.mfa(torch.cat(feats, dim=-1))
        h = _layer_norm(self.asp(h, m), self.asp_norm)
        h = _conv(h, self.fc)[:, 0, :]
        return F.normalize(h, dim=-1, eps=1e-12)


def remap_prosody_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Strip the ``prosody_encoder.`` / ``prosody_encoder_model.`` prefixes of
    a reference checkpoint (JAX ``remap_prosody_state_dict``)."""
    prefixes = ("prosody_encoder_model.", "prosody_encoder.")
    if any(k.startswith(p) for k in sd for p in prefixes):
        out = {}
        for k, v in sd.items():
            for p in prefixes:
                if k.startswith(p):
                    out[k[len(p):]] = v
                    break
        return out
    return dict(sd)


class ProsodyEncoder:
    """Frozen prosody encoder: raw 16 kHz audio -> ``[embed_dim]`` embedding.
    The model lives in f32 on ``device``; ``embed`` returns an f32 tensor
    there (the JAX wrapper returns numpy)."""

    def __init__(self, cfg: ECAPAConfig, model: ECAPA_TDNN):
        self.cfg = cfg
        self.model = model.float().eval()

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def build(cls, cfg_path: str = "", ckpt_path: str = "", allow_random: bool = True,
              device="cpu") -> "ProsodyEncoder":
        """From a Pretssel cfg JSON (else the default widths) and a reference
        checkpoint; without one, random weights from seed 0 (warned), or
        ``FileNotFoundError`` when ``allow_random`` is false."""
        cfg = (ECAPAConfig.from_pretssel_json(cfg_path)
               if cfg_path and Path(cfg_path).is_file() else ECAPAConfig())
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = ECAPA_TDNN(cfg)
        if ckpt_path and Path(ckpt_path).is_file():
            from lemas_tts_tpu_torch.weights import load_prosody_checkpoint

            model.load_state_dict(load_prosody_checkpoint(ckpt_path))
        elif allow_random:
            warnings.warn(f"no prosody ckpt at {ckpt_path!r} — random init")
        else:
            raise FileNotFoundError(ckpt_path)
        return cls(cfg, model.to(device))

    @torch.no_grad()
    def __call__(self, fbank: torch.Tensor, frame_mask=None) -> torch.Tensor:
        """``[B, T, 80]`` fbank -> ``[B, embed_dim]``."""
        return self.model(fbank.float(), frame_mask)

    @torch.no_grad()
    def embed(self, audio_16k) -> torch.Tensor:
        """Raw 16 kHz mono audio (numpy or tensor) -> ``[embed_dim]``."""
        if not torch.is_tensor(audio_16k):
            audio_16k = torch.from_numpy(np.ascontiguousarray(audio_16k, np.float32))
        return self(extract_fbank_16k(audio_16k.to(self.device))[None])[0]
