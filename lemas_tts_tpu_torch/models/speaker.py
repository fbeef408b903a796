"""Speaker encoder: SpeechBrain-style ECAPA-TDNN (counterpart of
``lemas_tts_tpu/models/speaker.py``): mel [B, T, D] -> [B, embed_dim].

BN-TDNN blocks (conv -> ReLU -> BatchNorm), SE-Res2Net blocks (res2net
scale 4), multi-layer feature aggregation, attentive statistics pooling with
global context, BatchNorm and a final projection. The module layout follows
the JAX module's names (``block_{i}``, ``mfa``, ``asp_tdnn``, ``asp_conv``,
``asp_bn``, ``fc``), so ``weights.speaker_state_from_jax`` carries a JAX
variable tree (BatchNorm statistics included) across.

BatchNorm is flax's: ``forward(train=True)`` normalises by the batch's
biased variance (``E[x²] - E[x]²``, clipped at 0) and moves the running
statistics with momentum 0.9 toward it (torch's ``BatchNorm1d`` would move
the variance toward the unbiased one); ``train=False`` uses the running
statistics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class SpeakerConfig:
    input_dim: int = 100  # mel channels
    embed_dim: int = 1024  # transformer dim
    channels: Tuple[int, ...] = (512, 512, 512, 512, 1536)
    kernel_sizes: Tuple[int, ...] = (5, 3, 3, 3, 1)
    dilations: Tuple[int, ...] = (1, 2, 3, 4, 1)
    attention_channels: int = 128
    res2net_scale: int = 4
    se_channels: int = 128
    global_context: bool = True


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last axis."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class Conv(nn.Module):
    """Channel-last 1-D convolution, padded ``dilation·(k-1)//2`` each side."""

    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        pad = dilation * (kernel_size - 1) // 2
        self.conv = nn.Conv1d(cin, cout, kernel_size, dilation=dilation, padding=pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.transpose(1, 2)).transpose(1, 2)


class BNTDNN(nn.Module):
    """conv -> ReLU -> BatchNorm (SpeechBrain TDNNBlock order)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        self.conv = Conv(cin, cout, kernel_size, dilation)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.bn(F.relu(self.conv(x)), train)


class Res2Net(nn.Module):
    def __init__(self, channels: int, scale: int, kernel_size: int, dilation: int):
        super().__init__()
        hidden = channels // scale
        self.scale = scale
        self.blocks = nn.ModuleList([BNTDNN(hidden, hidden, kernel_size, dilation)
                                     for _ in range(scale - 1)])

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        ys, y = [], None
        for i, xi in enumerate(torch.chunk(x, self.scale, dim=-1)):
            if i == 0:
                y = xi
            elif i == 1:
                y = self.blocks[0](xi, train)
            else:
                y = self.blocks[i - 1](xi + y, train)
            ys.append(y)
        return torch.cat(ys, dim=-1)


class SE(nn.Module):
    def __init__(self, channels: int, se_channels: int):
        super().__init__()
        self.conv1 = Conv(channels, se_channels, 1)
        self.conv2 = Conv(se_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=1, keepdim=True)
        return torch.sigmoid(self.conv2(F.relu(self.conv1(s)))) * x


class SERes2Net(nn.Module):
    def __init__(self, cin: int, channels: int, scale: int, se_channels: int,
                 kernel_size: int, dilation: int):
        super().__init__()
        self.shortcut = Conv(cin, channels, 1) if cin != channels else None
        self.tdnn1 = BNTDNN(cin, channels, 1)
        self.res2net = Res2Net(channels, scale, kernel_size, dilation)
        self.tdnn2 = BNTDNN(channels, channels, 1)
        self.se = SE(channels, se_channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        residual = x if self.shortcut is None else self.shortcut(x)
        h = self.tdnn2(self.res2net(self.tdnn1(x, train), train), train)
        return self.se(h) + residual


class SpeakerEncoder(nn.Module):
    """mel [B, T, input_dim] -> [B, embed_dim] speaker embedding."""

    def __init__(self, cfg: SpeakerConfig = SpeakerConfig()):
        super().__init__()
        self.cfg = c = cfg
        blocks = [BNTDNN(c.input_dim, c.channels[0], c.kernel_sizes[0], c.dilations[0])]
        for i in range(1, len(c.channels) - 1):
            blocks.append(SERes2Net(c.channels[i - 1], c.channels[i], c.res2net_scale,
                                    c.se_channels, c.kernel_sizes[i], c.dilations[i]))
        self.blocks = nn.ModuleList(blocks)
        C = c.channels[-1]
        self.mfa = BNTDNN(sum(c.channels[1:-1]), C, c.kernel_sizes[-1], c.dilations[-1])
        self.asp_tdnn = BNTDNN(C * 3 if c.global_context else C, c.attention_channels, 1)
        self.asp_conv = Conv(c.attention_channels, C, 1)
        self.asp_bn = BatchNorm(2 * C)
        self.fc = nn.Linear(2 * C, c.embed_dim)

    def forward(self, mel: torch.Tensor, train: bool = False) -> torch.Tensor:
        feats = []
        h = mel
        for blk in self.blocks:
            h = blk(h, train)
            feats.append(h)
        h = self.mfa(torch.cat(feats[1:], dim=-1), train)

        # attentive statistics pooling with global context
        B, T, C = h.shape
        mean = h.mean(dim=1, keepdim=True).expand(B, T, C)
        std = torch.sqrt(torch.clamp(h.var(dim=1, keepdim=True, correction=0),
                                     min=1e-12)).expand(B, T, C)
        ctx = torch.cat([h, mean, std], dim=-1) if self.cfg.global_context else h
        attn = self.asp_conv(torch.tanh(self.asp_tdnn(ctx, train)))
        w = torch.softmax(attn, dim=1)
        p_mean = (w * h).sum(dim=1)
        p_std = torch.sqrt(torch.clamp((w * torch.square(h - p_mean[:, None, :])).sum(dim=1),
                                       min=1e-12))
        pooled = self.asp_bn(torch.cat([p_mean, p_std], dim=-1), train)
        return self.fc(pooled)
