"""Rooflines of the port's hand-written kernels: which kernels a sampler call
runs, their operations and bytes per call, and their symbols in a trace.

The arithmetic is a frozen copy of the "Bound" column of ``PERF.md`` §6 at
commit a2fd43e (``chip_smoke.py:phase_kernels`` and
``phase_split_attention``): bound = max(bytes / 3.35 TB/s, FLOP / peak),
each input byte counted once and each output byte once; attention counts
the keys its mask leaves (4 · heads · dim_head · N · valid keys). At rows 2,
N 1024, 16 × 64 heads, bf16 that gives K1 0.0130, K2 0.0174, K3 0.0080 (valid
keys 1024 and 859) and K5 0.0085 ms (1024 - 37 and 1024), the table's values.

Which kernels run is the block's routing (``models/modules.py`` at a2fd43e):
under the ``vmem`` backend a block with rope on every head, no qk norm and
d64 heads in pairs (or d128) runs K1 + K3 for attention, else the split-head
chain with K5; the feed-forward side is K2; W8A8 int8 takes the q/k/v, out
and feed-forward products to ``torch._int_mm``, which leaves K1 and K2 and
keeps K3 or K5.
"""

from __future__ import annotations

import re
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


def is_call(kernel: str, name: str) -> bool:
    mark = CALL_MARK.get(kernel)
    return mark.search(name) is not None if mark else True


def block_kernels(arch: dict, quant: Optional[str]) -> List[str]:
    """The hand-written kernels one block evaluation launches, once each."""
    heads, dh = arch["heads"], arch["dim_head"]
    flat = (arch.get("qk_norm") is None and arch.get("pe_attn_head") is None
            and ((dh == 64 and heads % 2 == 0) or dh == 128))
    out = []
    if quant is None:
        out += ["K1", "K3"] if flat else ["K5"]
        out.append("K2")
    else:
        out.append("K3" if flat else "K5")
    return out


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


def batch_bounds(arch: dict, sampler: dict, quant: Optional[str], n: int,
                 durations: List[int]) -> Dict[str, list]:
    """``{kernel: [calls, seconds at the roofline]}`` of one sampler call
    whose padded batch rows have ``durations`` (frames) in an ``n`` bucket."""
    out: Dict[str, list] = {}
    valid = float(sum(min(d, n) for d in durations))
    for width, blocks in schedule(sampler, arch["depth"]):
        rows = width * len(durations)
        for k in block_kernels(arch, quant):
            c = out.setdefault(k, [0, 0.0])
            c[0] += blocks
            c[1] += blocks * call_bound(k, arch, rows, n, width * valid)
    return out
