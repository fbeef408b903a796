"""Analytic FLOP model of the CFM sampler and the card's peak, for model FLOP
utilisation (counterpart of ``lemas_tts_tpu/utils/flops.py``).

MFU = analytic useful FLOPs / card time / peak. The model counts the matmul
work of the DiT velocity forward (attention projections, scores and values,
FF, per-block AdaLN modulation, input and text embedding, output head) and
composes it over the sampler's real step schedule: the CFG-active prefix at
width 2B (``SamplerSettings.cfg_active_steps``), the cond-only tail at width
B, block-cache steps that skip ``hi - lo`` blocks (``block_cache_flags``,
with the forced refresh where the width halves) and midpoint's two
evaluations a step. Elementwise, softmax and norm FLOPs and the vocoder are
left out, so the MFU it gives is slightly low. The numbers are the JAX
package's, function for function.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np

from lemas_tts_tpu_torch.cfm.sampler import block_cache_flags, sway_time_grid


def dit_block_flops_per_row(arch: Any, n: int) -> float:
    """Matmul FLOPs of one DiT block for one batch row of ``n`` frames
    (a multiply-accumulate is 2 FLOPs)."""
    d = arch.dim
    inner = arch.heads * arch.dim_head
    attn_proj = 8.0 * n * d * inner          # q, k, v and out projections
    attn_core = 4.0 * n * n * inner          # q·kᵀ and attn·v
    ff = 4.0 * arch.ff_mult * n * d * d      # up and down products
    modulation = 12.0 * d * d                # AdaLN: t_emb -> 6 modulation vectors
    return attn_proj + attn_core + ff + modulation


def dit_embed_head_flops_per_row(arch: Any, n: int, mel_dim: int) -> float:
    """Non-block matmul work of one velocity call for one row: the input
    projection, ConvPositionEmbedding (2 grouped convs, k 31, 16 groups), the
    timestep MLP, the final AdaLN and the mel projection."""
    d = arch.dim
    text_dim = arch.text_dim if arch.text_dim is not None else mel_dim
    input_proj = 2.0 * n * (2 * mel_dim + text_dim) * d
    conv_pos = 2 * (2.0 * n * d * (d / 16.0) * 31)
    time_mlp = 4.0 * d * d
    head = 4.0 * d * d + 2.0 * n * d * mel_dim
    return input_proj + conv_pos + time_mlp + head


def text_embed_flops_per_row(arch: Any, n: int, mel_dim: int) -> float:
    """The text embedding's ConvNeXtV2 stack for one row (once per sampler
    call and CFG branch, not per step): per layer a depthwise k 7 conv and
    two pointwise products at ``conv_mult`` expansion."""
    td = arch.text_dim if arch.text_dim is not None else mel_dim
    per_layer = 2.0 * n * td * 7 + 2 * (2.0 * n * td * td * arch.conv_mult)
    return arch.conv_layers * per_layer


def sampler_call_flops(arch: Any, settings: Any, batch: int, n: int,
                       mel_dim: int = 100) -> float:
    """Analytic FLOPs of one sampler call on a [batch, n] bucket under
    ``settings``' real step schedule."""
    grid = sway_time_grid(settings.steps, settings.sway_sampling_coef, settings.t_start)
    steps = settings.steps
    k = settings.cfg_active_steps(grid)  # 0 without CFG

    if settings.block_cache_range is not None:
        lo, hi = settings.block_cache_range
        flags = block_cache_flags(settings, steps)
        if settings.use_cfg and k < steps:
            flags[k] = True  # forced refresh where the width halves (2B -> B)
        blocks_per_step = np.where(flags, arch.depth, arch.depth - (hi - lo))
    else:
        blocks_per_step = np.full(steps, arch.depth)

    evals = 2 if settings.method == "midpoint" else 1
    widths = np.where(np.arange(steps) < k, 2 * batch, batch)
    block_row = dit_block_flops_per_row(arch, n)
    embed_row = dit_embed_head_flops_per_row(arch, n, mel_dim)
    total = float(np.sum(widths * (blocks_per_step * block_row + embed_row) * evals))
    n_te = 2 if settings.use_cfg else 1  # both CFG branches embed the text
    return total + n_te * batch * text_embed_flops_per_row(arch, n, mel_dim)


# Dense bf16 tensor-core peak by CUDA device name, TFLOP/s, from NVIDIA's
# H100 datasheet (SXM5 part, without sparsity).
_PEAK_BF16_TFLOPS = (("h100 80gb hbm3", 989.4),)


def device_peak_flops(device=None) -> Optional[float]:
    """Dense bf16 peak FLOP/s of a CUDA device (default: the current one),
    from its name; None for the CPU, a machine without CUDA and a card not in
    the table. ``LEMAS_BENCH_PEAK_TFLOPS`` overrides it (a card not listed)."""
    env = os.environ.get("LEMAS_BENCH_PEAK_TFLOPS")
    if env:
        return float(env) * 1e12
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, tf in _PEAK_BF16_TFLOPS:
        if key in name:
            return tf * 1e12
    return None
