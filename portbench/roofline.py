"""Rooflines of the port's hand-written kernels: which kernels a sampler call
runs, their operations and bytes per call, and their symbols in a trace.
K1-K6 are here; another kernel is a file of its own,
``portbench/kernels/<name>.py``, found by name (``spec.Bench.kernel``), with
``SYMBOL`` (its launches in a trace), ``CALL_MARK`` (the launch that marks
one call, None where every launch is one), ``PER`` (``"block"`` or
``"forward"``: what ``calls(config, quant)`` counts its calls in) and
``cost(config, rows, n, valid_keys)`` (its bytes and operations per call).

The arithmetic is a frozen copy of the "Bound" column of ``PERF.md`` §6 at
commit a2fd43e (``chip_smoke.py:phase_kernels`` and
``phase_split_attention``): bound = max(bytes / 3.35 TB/s, FLOP / peak),
each input byte counted once and each output byte once; attention counts
the keys its mask leaves (4 · heads · dim_head · N · valid keys). At rows 2,
N 1024, 16 × 64 heads, bf16 that gives K1 0.0130, K2 0.0174, K3 0.0080 (valid
keys 1024 and 859) and K5 0.0085 ms (1024 - 37 and 1024), the table's values.

Which of K1-K6 one block evaluation runs is its backbone family's
``block_kernels`` (``portbench/backbones/``).
"""

from __future__ import annotations

import re
from types import ModuleType
from typing import Dict, List, Optional

from portbench.flops import HBM_BYTES_PER_S, PEAKS, schedule

ESZ = 2  # bfloat16 bytes

# trace symbols of each kernel's launches (a call of K1 is two launches, of K2
# three); the gemm's last template argument is its epilogue: 0 K1's q/k/v, 1 and
# 2 K2's up and down products
SYMBOLS = {
    "K1": re.compile(r"ln_mod_kernel|gemm_sm90_kernel<[^>]*\b0>"),
    "K2": re.compile(r"ln_stats_kernel|gemm_sm90_kernel<[^>]*\b[12]>"),
    "K3": re.compile(r"attn_nhd_sm90_kernel<\s*\d+\s*,\s*false"),
    "K4": re.compile(r"attn_nhd_sm90_kernel<\s*\d+\s*,\s*true"),
    "K5": re.compile(r"attn_bhnd_sm90_kernel"),
    "K6": re.compile(r"attn_splash"),
}
# the launch that marks one call of each kernel
CALL_MARK = {"K1": re.compile(r"gemm_sm90_kernel<[^>]*\b0>"),
             "K2": re.compile(r"gemm_sm90_kernel<[^>]*\b2>")}


def kernel_of(name: str) -> Optional[str]:
    for k, pat in SYMBOLS.items():
        if pat.search(name):
            return k
    return None


def is_launch(kernel: str, name: str, found: Optional[ModuleType] = None) -> bool:
    """Whether the trace's ``name`` is a launch of ``kernel``; ``found``, the
    kernel's file for a kernel that is not one of K1-K6."""
    if found is not None:
        return found.SYMBOL.search(name) is not None
    return kernel_of(name) == kernel


def is_call(kernel: str, name: str, found: Optional[ModuleType] = None) -> bool:
    mark = found.CALL_MARK if found is not None else CALL_MARK.get(kernel)
    return mark.search(name) is not None if mark else True


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAKS["bf16"])


def call_bound(kernel: str, arch: dict, rows: int, n: int, valid_keys: float) -> float:
    """Seconds at the roofline of one call on ``rows`` batch rows of ``n``
    frames whose masks leave ``valid_keys`` keys in all."""
    D = arch["dim"]
    heads, dh = arch["heads"], arch["dim_head"]
    inner = heads * dh
    FF = D * arch["ff_mult"]
    if kernel == "K1":
        nbytes = (rows * n * D + 2 * rows * D + 3 * inner * D + 3 * inner
                  + 3 * rows * n * inner) * ESZ
        return bound_s(nbytes, 2.0 * rows * n * D * 3 * inner)
    if kernel == "K2":
        nbytes = (2 * rows * n * D + 3 * rows * D + 2 * FF * D + FF + D) * ESZ
        return bound_s(nbytes, 4.0 * rows * n * D * FF)
    if kernel in ("K3", "K4"):
        nbytes = 4 * rows * n * inner * ESZ + rows * n + n * dh // 2 * 4
        return bound_s(nbytes, 4.0 * heads * dh * n * valid_keys)
    if kernel in ("K5", "K6"):
        nbytes = 4 * rows * heads * n * dh * ESZ + rows * n
        return bound_s(nbytes, 4.0 * heads * dh * n * valid_keys)
    raise ValueError(kernel)


def batch_bounds(backbone: ModuleType, config: dict, sampler: dict, quant: Optional[str],
                 n: int, durations: List[int],
                 files: Optional[Dict[str, ModuleType]] = None) -> Dict[str, list]:
    """``{kernel: [calls, seconds at the roofline]}`` of one sampler call
    whose padded batch rows have ``durations`` (frames) in an ``n`` bucket:
    the backbone family's block kernels, and those of ``files`` (kernel
    files by name) that its configuration runs."""
    arch = config["model"]["arch"]
    out: Dict[str, list] = {}
    valid = float(sum(min(d, n) for d in durations))
    for width, blocks in schedule(sampler, backbone.depth(config)):
        rows = width * len(durations)
        for k in backbone.block_kernels(config, quant):
            c = out.setdefault(k, [0, 0.0])
            c[0] += blocks
            c[1] += blocks * call_bound(k, arch, rows, n, width * valid)
        for k, f in (files or {}).items():
            calls = f.calls(config, quant) * (blocks if f.PER == "block" else 1)
            if calls:
                c = out.setdefault(k, [0, 0.0])
                c[0] += calls
                c[1] += calls * bound_s(*f.cost(config, rows, n, width * valid))
    return out
