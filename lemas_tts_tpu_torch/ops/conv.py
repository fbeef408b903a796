"""The grouped convolutions of ``ConvPositionEmbedding``: ``conv_taps_mish``.

One grouped 1-D convolution, channel-last, with its bias and Mish:
``mish(T(conv(x) + bias))`` on x ``[B, N, C]`` with ``(left, right)`` zero
rows of padding around each batch row. It is a CUDA kernel
(``csrc/conv_taps.cu``; it replaces no TPU kernel: the JAX package runs the
conv as shifted taps in XLA, ``lemas_tts_tpu/models/modules.py:
GroupedConvTaps``) with a plain PyTorch version beside it that repeats the
JAX tap form and its rounding points:

- K shifted ``[B, N, g, C/g] x [g, C/g, C/g]`` products accumulated in f32;
- ``+ bias`` in f32, then rounded to the compute dtype;
- ``x * tanh(softplus(x))`` in f32, rounded again.

The weights go in as taps ``[g, K, C/g out, C/g in]`` (``conv_taps`` makes
them from a torch ``Conv1d`` weight ``[C, C/g, K]``): each tap is then one
K-major ``[64, 64]`` operand of the kernel's products. Dispatch is by the
tensors' device: CPU tensors take the plain version, CUDA tensors launch the
kernel (bf16 or f32, 64 channels a group, K up to 129) or raise. The wrapper
counts its launches in ``.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from lemas_tts_tpu_torch.ops import _cuda, launches

GROUP_WIDTH = 64  # channels a group that the kernel takes
MAX_TAPS = 129  # its 128-frame tile plus K - 1 halo rows fill at most one 256-row TMA box


def conv_taps(weight: torch.Tensor, groups: int, dtype: torch.dtype) -> torch.Tensor:
    """A torch ``Conv1d`` weight ``[C, C/g, K]`` as taps ``[g, K, C/g, C/g]``
    (output channel, then input channel), contiguous, in ``dtype``."""
    c, cin, k = weight.shape
    return (weight.to(dtype).reshape(groups, c // groups, cin, k).permute(0, 3, 1, 2)
            .contiguous())


def _out_frames(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
                padding: Tuple[int, int]) -> int:
    """Frames of the output; raises on shapes that do not fit together."""
    _cuda.require(x.dim() == 3, f"x must be [B, N, C], got {tuple(x.shape)}")
    _cuda.require(taps.dim() == 4 and taps.shape[2] == taps.shape[3],
                  f"taps must be [groups, K, C/groups, C/groups], got {tuple(taps.shape)}")
    g, k, cg, _ = taps.shape
    _cuda.require(x.shape[2] == g * cg, f"x has {x.shape[2]} channels, the taps {g} x {cg}")
    _cuda.require(tuple(bias.shape) == (g * cg,), f"bias must be [{g * cg}]")
    left, right = padding
    _cuda.require(left >= 0 and right >= 0, f"padding must be non-negative, got {padding}")
    n_out = x.shape[1] + left + right - k + 1
    _cuda.require(n_out >= 1, f"{x.shape[1]} frames padded {padding} are fewer than K={k}")
    return n_out


def conv_taps_mish_plain(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
                         padding: Tuple[int, int]) -> torch.Tensor:
    """The kernel's function in PyTorch, at its rounding points."""
    n_out = _out_frames(x, taps, bias, padding)
    g, k, cg, _ = taps.shape
    B, N, C = x.shape
    xg = F.pad(x.float(), (0, 0, *padding)).view(B, N + sum(padding), g, cg)
    w = taps.float()
    acc = torch.zeros(B, n_out, g, cg, dtype=torch.float32, device=x.device)
    for t in range(k):
        acc += torch.einsum("bngi,goi->bngo", xg[:, t:t + n_out], w[:, t])
    h = (acc.reshape(B, n_out, C) + bias.float()).to(x.dtype).float()
    return (h * torch.tanh(F.softplus(h))).to(x.dtype)


def conv_taps_mish(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
                   padding: Tuple[int, int]) -> torch.Tensor:
    """``mish(T(conv(x) + bias))`` of one grouped conv: x ``[B, N, C]``, taps
    ``[g, K, C/g, C/g]`` (``conv_taps``), bias ``[C]``, ``padding`` (left,
    right) zero frames. Returns ``[B, N + left + right - K + 1, C]`` in x's
    dtype."""
    if x.device.type == "cpu":
        return conv_taps_mish_plain(x, taps, bias, padding)
    _cuda.require(x.device.type == "cuda", f"no kernel for device {x.device}")
    _cuda.refuse_grad("conv_taps_mish", x, taps, bias)
    n_out = _out_frames(x, taps, bias, padding)
    g, k, cg, _ = taps.shape
    _cuda.require(cg == GROUP_WIDTH,
                  f"conv_taps_mish kernel takes {GROUP_WIDTH} channels a group, not {cg}")
    _cuda.require(k <= MAX_TAPS, f"conv_taps_mish kernel takes K <= {MAX_TAPS}, not {k}")
    for t in (x, taps, bias):
        _cuda.require(t.device == x.device, "all operands must be on one device")
        _cuda.require(t.dtype == x.dtype, f"operand dtype {t.dtype} differs from x's {x.dtype}")
        _cuda.require(t.is_contiguous(), "operands must be contiguous")
    _cuda.require(x.data_ptr() % 16 == 0, "x must be 16-byte aligned (a TMA map reads it)")
    B, N, C = x.shape
    out = torch.empty(B, n_out, C, device=x.device, dtype=x.dtype)
    err = _cuda.library("conv_taps").lemas_conv_taps_mish(
        x.device.index, _cuda.dtype_code(x), x.data_ptr(), taps.data_ptr(), bias.data_ptr(),
        out.data_ptr(), B, N, n_out, C, k, padding[0], _cuda.stream_ptr(x.device))
    _cuda.check(err, "conv_taps_mish")
    launches.count(conv_taps_mish)
    return out


conv_taps_mish.launches = 0
