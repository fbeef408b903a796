"""Frozen copy of the sampler's analytic FLOP model, with the peaks that a
whole step's share is taken against.

Copied from ``lemas_tts_tpu_torch/utils/flops.py`` at commit a2fd43e
(``dit_block_flops_per_row``, ``dit_embed_head_flops_per_row``,
``text_embed_flops_per_row``, ``sampler_call_flops``), so that a later change
to the program does not move the yardstick; the sway grid and the
block-cache flags are the reference's (``reference/request.py``). Added
here: the count split by the precision each product runs in (under W8A8 the
q/k/v, out and feed-forward products are int8, the rest bf16), since each
part is held against its own peak.

Matmul work only: elementwise, softmax, norm work and the vocoder are left
out, so a share from it reads slightly low.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from portbench.reference.request import refresh_flags, time_grid

# Dense peaks of one NVIDIA H100 SXM (data sheet, without sparsity, 700 W)
PEAKS = {"bf16": 989.4e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def cfg_active_steps(sampler: dict, grid: np.ndarray) -> int:
    steps = len(grid) - 1
    if sampler["cfg_strength"] < 1e-5:
        return 0
    if sampler.get("cfg_cutoff") is None:
        return steps
    ts = np.asarray(grid)[:-1]
    return int(np.sum(sampler["cfg_strength"] * np.square(1.0 - ts) >= sampler["cfg_cutoff"]))


def cache_plan(sampler: dict, steps: int):
    """``(lo, hi)`` and refresh flags of the block cache (None when off),
    with the forced refresh where the CFG width halves."""
    plan = refresh_flags(steps, sampler.get("block_cache"))
    if plan is None:
        return None
    (lo, hi), flags = plan
    k = cfg_active_steps(sampler, time_grid(steps, sampler.get("sway_sampling_coef")))
    if sampler["cfg_strength"] >= 1e-5 and k < steps:
        flags[k] = True
    return (lo, hi), flags


def schedule(sampler: dict, depth: int) -> list:
    """``[(width factor 2 or 1, blocks evaluated)]`` for each step."""
    steps = int(sampler["nfe_steps"])
    grid = time_grid(steps, sampler.get("sway_sampling_coef"))
    k = cfg_active_steps(sampler, grid)
    plan = cache_plan(sampler, steps)
    out = []
    for i in range(steps):
        blocks = depth
        if plan is not None:
            (lo, hi), flags = plan
            blocks = depth if flags[i] else depth - (min(hi, depth) - lo)
        out.append((2 if i < k else 1, blocks))
    return out


def block_flops_per_row(arch: dict, n: int) -> Dict[str, float]:
    """One block, one row of ``n`` frames: ``proj`` (q, k, v, out and the
    feed-forward products, the ones W8A8 quantizes) and ``other``."""
    d = arch["dim"]
    inner = arch["heads"] * arch["dim_head"]
    attn_proj = 8.0 * n * d * inner
    attn_core = 4.0 * n * n * inner
    ff = 4.0 * arch["ff_mult"] * n * d * d
    modulation = 12.0 * d * d
    return {"proj": attn_proj + ff, "other": attn_core + modulation}


def embed_head_flops_per_row(arch: dict, n: int, mel_dim: int) -> float:
    d = arch["dim"]
    text_dim = arch["text_dim"] if arch.get("text_dim") is not None else mel_dim
    input_proj = 2.0 * n * (2 * mel_dim + text_dim) * d
    conv_pos = 2 * (2.0 * n * d * (d / 16.0) * 31)
    time_mlp = 4.0 * d * d
    head = 4.0 * d * d + 2.0 * n * d * mel_dim
    return input_proj + conv_pos + time_mlp + head


def text_embed_flops_per_row(arch: dict, n: int, mel_dim: int) -> float:
    td = arch["text_dim"] if arch.get("text_dim") is not None else mel_dim
    per_layer = 2.0 * n * td * 7 + 2 * (2.0 * n * td * td * arch.get("conv_mult", 2))
    return arch["conv_layers"] * per_layer


def sampler_call_flops(arch: dict, sampler: dict, batch: int, n: int, mel_dim: int = 100,
                       quant: Optional[str] = None) -> Dict[str, float]:
    """FLOPs of one sampler call on a ``[batch, n]`` bucket, by the peak
    each part is held against: ``{"bf16": ..., "int8": ...}``."""
    blk = block_flops_per_row(arch, n)
    embed = embed_head_flops_per_row(arch, n, mel_dim)
    proj = other = 0.0
    for width, blocks in schedule(sampler, arch["depth"]):
        rows = width * batch
        proj += rows * blocks * blk["proj"]
        other += rows * (blocks * blk["other"] + embed)
    n_te = 2 if sampler["cfg_strength"] >= 1e-5 else 1
    other += n_te * batch * text_embed_flops_per_row(arch, n, mel_dim)
    if quant == "int8":
        return {"bf16": other, "int8": proj}
    return {"bf16": other + proj, "int8": 0.0}


def peak_seconds(flops: Dict[str, float]) -> float:
    """The least time the chip needs for ``flops`` at its peaks."""
    return sum(v / PEAKS[k] for k, v in flops.items())
