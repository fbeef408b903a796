"""The peaks that a whole step's share is taken against, and the sampler's
schedule that every backbone family's FLOP count and the kernels' calls
follow: which steps run CFG at twice the width, and how many blocks each
evaluates under the block cache (the sway grid and the block-cache flags are
the reference's, ``reference/request.py``). Each family's count of one
sampler call is in ``portbench/backbones/<name>.py`` (``sampler_call_flops``).
"""

from __future__ import annotations

from typing import Dict

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


def peak_seconds(flops: Dict[str, float]) -> float:
    """The least time the chip needs for ``flops`` at its peaks."""
    return sum(v / PEAKS[k] for k, v in flops.items())
