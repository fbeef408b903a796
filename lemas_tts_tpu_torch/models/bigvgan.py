"""BigVGAN vocoder, v2 generator (counterpart of
``lemas_tts_tpu/models/bigvgan.py``).

conv_pre -> per stage [transposed-conv upsample -> mean of the AMP
resblocks, each 3 x (anti-aliased SnakeBeta -> dilated conv -> anti-aliased
SnakeBeta -> conv) with residuals] -> anti-aliased SnakeBeta -> conv_post
-> clip. Each anti-aliased activation is upsample x2 (edge padding and a
depthwise transposed conv with shared Kaiser-sinc taps), the snake, then
downsample /2 (edge padding and a depthwise strided conv): ``F.conv_transpose1d``
and ``F.conv1d`` with ``groups=C``.

Layout is channel-first ``[B, C, T]``. Parameter names are NVIDIA's
(``conv_pre``, ``ups.{i}.0``, ``resblocks.{k}.convs1.{d}``,
``resblocks.{k}.activations.{j}.act.alpha``, ``activation_post.act.beta``,
``conv_post``), with weight norm folded at load (``weights.py``). As in the
JAX module the convs run in the compute dtype, the snake's exp-scale
parameters and the filter taps are cast to the activations' dtype, and
``conv_post`` runs in f32 (flax promotes its bf16 input against its f32
parameters).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SILENCE = float(np.log(1e-5))  # the BigVGAN mel's log floor


@dataclass(frozen=True)
class BigVGANConfig:
    """Generator hyper-parameters (defaults: bigvgan_v2_24khz_100band_256x)."""

    num_mels: int = 100
    upsample_initial_channel: int = 1536
    upsample_rates: Tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    activation: str = "snakebeta"  # "snake" | "snakebeta"
    snake_logscale: bool = True
    use_bias_at_final: bool = False
    use_tanh_at_final: bool = False

    @property
    def total_upsample(self) -> int:
        return math.prod(self.upsample_rates)

    @classmethod
    def for_hop(cls, hop_length: int, num_mels: int = 100, **kw) -> "BigVGANConfig":
        """Upsample rates multiplying to ``hop_length``: up to two 4s, then
        2s (hop 256 gives the published v2 24 kHz config)."""
        rates = []
        h = hop_length
        while h % 4 == 0 and len(rates) < 2:
            rates.append(4)
            h //= 4
        while h > 1:
            if h % 2:
                raise ValueError(f"hop_length {hop_length} is not 4^a * 2^b")
            rates.append(2)
            h //= 2
        return cls(num_mels=num_mels, upsample_rates=tuple(rates),
                   upsample_kernel_sizes=tuple(2 * r for r in rates), **kw)


@lru_cache(maxsize=16)
def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Low-pass taps of the alias-free filter design: Kaiser window chosen by
    the attenuation, normalised sinc (f32)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21.0) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    time = (np.arange(-half_size, half_size) + 0.5) if even else (np.arange(kernel_size)
                                                                  - half_size)
    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    f = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    f /= f.sum()
    return f.astype(np.float32)


def resample_taps(ratio: int = 2) -> torch.Tensor:
    """The shared taps of ``upsample2x`` / ``downsample2x`` at ``ratio``."""
    ks = int(6 * ratio // 2) * 2
    return torch.from_numpy(kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, ks))


def _depthwise_taps(taps: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return taps.to(x.dtype)[None, None, :].expand(x.shape[1], 1, taps.shape[0])


def upsample2x(x: torch.Tensor, taps: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """Anti-aliased x ``ratio`` upsampling of ``[B, C, T]`` -> ``[B, C, ratio T]``."""
    ks = taps.shape[0]
    pad = ks // ratio - 1
    pad_left = pad * ratio + (ks - ratio) // 2
    pad_right = pad * ratio + (ks - ratio + 1) // 2
    x = F.pad(x, (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(x, _depthwise_taps(taps, x), stride=ratio, groups=x.shape[1])
    return y[..., pad_left: y.shape[-1] - pad_right]


def downsample2x(x: torch.Tensor, taps: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """Anti-aliased / ``ratio`` downsampling of ``[B, C, T]``."""
    ks = taps.shape[0]
    x = F.pad(x, (ks // 2 - int(ks % 2 == 0), ks // 2), mode="replicate")
    return F.conv1d(x, _depthwise_taps(taps, x), stride=ratio, groups=x.shape[1])


class Snake(nn.Module):
    """Snake / SnakeBeta: ``x + 1/(beta + 1e-9) * sin(alpha x)^2``, with
    log-scale ``alpha``/``beta`` (exp taken in f32, then cast to x's dtype)."""

    def __init__(self, channels: int, variant: str = "snakebeta", logscale: bool = True):
        super().__init__()
        self.variant, self.logscale = variant, logscale
        init = torch.zeros if logscale else torch.ones
        self.alpha = nn.Parameter(init(channels))
        self.beta = nn.Parameter(init(channels)) if variant == "snakebeta" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha
        beta = alpha if self.beta is None else self.beta
        if self.logscale:
            alpha, beta = torch.exp(alpha), torch.exp(beta)
        alpha, beta = alpha.to(x.dtype)[:, None], beta.to(x.dtype)[:, None]
        return x + (1.0 / (beta + 1e-9)) * torch.square(torch.sin(alpha * x))


class Activation1d(nn.Module):
    """upsample x2 -> snake -> downsample /2."""

    def __init__(self, channels: int, variant: str = "snakebeta", logscale: bool = True):
        super().__init__()
        self.act = Snake(channels, variant, logscale)
        self.register_buffer("taps", resample_taps(2), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return downsample2x(self.act(upsample2x(x, self.taps)), self.taps)


def _conv(x: torch.Tensor, conv: nn.Conv1d, dtype: Optional[torch.dtype] = None):
    """``conv`` over ``[B, C, T]`` with symmetric ``(k d - d) // 2`` padding,
    in ``dtype`` (default: x's)."""
    dtype = dtype or x.dtype
    k, d = conv.kernel_size[0], conv.dilation[0]
    b = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv1d(x.to(dtype), conv.weight.to(dtype), b, padding=(k * d - d) // 2, dilation=d)


class AMPBlock1(nn.Module):
    """Multi-receptive-field resblock: per dilation, act -> dilated conv ->
    act -> conv (dilation 1), residual."""

    def __init__(self, channels: int, kernel_size: int, dilations, variant: str,
                 logscale: bool):
        super().__init__()
        self.convs1 = nn.ModuleList([nn.Conv1d(channels, channels, kernel_size, dilation=d)
                                     for d in dilations])
        self.convs2 = nn.ModuleList([nn.Conv1d(channels, channels, kernel_size)
                                     for _ in dilations])
        self.activations = nn.ModuleList([Activation1d(channels, variant, logscale)
                                          for _ in range(2 * len(dilations))])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            h = _conv(self.activations[2 * j](x), c1)
            x = x + _conv(self.activations[2 * j + 1](h), c2)
        return x


class BigVGAN(nn.Module):
    """``decode``: log-mel ``[B, num_mels, T]`` -> wave ``[B, T * total_upsample]``."""

    def __init__(self, cfg: BigVGANConfig = BigVGANConfig(),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.conv_pre = nn.Conv1d(c.num_mels, c.upsample_initial_channel, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = c.upsample_initial_channel
        for rate, k in zip(c.upsample_rates, c.upsample_kernel_sizes):
            self.ups.append(nn.ModuleList([nn.ConvTranspose1d(ch, ch // 2, k, rate)]))
            ch //= 2
            for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                self.resblocks.append(AMPBlock1(ch, rk, rd, c.activation, c.snake_logscale))
        self.activation_post = Activation1d(ch, c.activation, c.snake_logscale)
        self.conv_post = nn.Conv1d(ch, 1, 7, bias=c.use_bias_at_final)
        self.conv_post.keep_f32 = True  # cast_matrices leaves it in f32

    def wave_length(self, n_frames: int) -> int:
        """Samples a decode of ``n_frames`` frames gives: a pure conv stack."""
        return n_frames * self.cfg.total_upsample

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = _conv(mel, self.conv_pre, self.compute_dtype)
        n_res = len(c.resblock_kernel_sizes)
        for i, (rate, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            up = self.ups[i][0]
            b = None if up.bias is None else up.bias.to(x.dtype)
            x = F.conv_transpose1d(x, up.weight.to(x.dtype), b, stride=rate)
            pad = (k - rate) // 2
            x = x[..., pad: x.shape[-1] - (k - rate - pad)]
            acc = None
            for blk in self.resblocks[i * n_res: (i + 1) * n_res]:
                h = blk(x)
                acc = h if acc is None else acc + h
            x = acc / n_res
        x = _conv(self.activation_post(x), self.conv_post, torch.float32)[:, 0]
        return torch.tanh(x) if c.use_tanh_at_final else torch.clamp(x, -1.0, 1.0)

    def decode(self, mel: torch.Tensor, frame_mask: Optional[torch.Tensor] = None):
        """As ``Vocos.decode``: padded frames are set to the log-mel floor
        before the stack (zeros would be loud broadband energy that the
        receptive field bleeds into the valid tail), and their samples are
        zeroed after it."""
        if frame_mask is not None:
            mel = torch.where(frame_mask[:, None, :], mel, SILENCE)
        wav = self(mel)
        if frame_mask is not None:
            keep = torch.repeat_interleave(frame_mask, self.cfg.total_upsample, dim=-1)
            wav = torch.where(keep[:, : wav.shape[-1]], wav, 0.0)
        return wav
