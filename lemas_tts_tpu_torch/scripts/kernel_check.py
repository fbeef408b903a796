"""Correctness gate of the DiT block's kernels on the card (counterpart of
``lemas_tts_tpu/scripts/kernel_check.py``).

Runs the full flagship DiT forward (dim 1024, depth 22, 16 x 64 heads) twice
per shape on the same random weights: with ``attn_backend="vmem"`` (K1-K3,
the path the serving numbers come from) and with ``attn_backend="xla"``
(plain PyTorch ``sdpa`` and products, no kernel of the port), and asserts
that they agree within a stated bf16 tolerance on the valid frames of a
batch whose last row is padded to half length.

The CPU tests hold each kernel's plain version against the JAX package; the
kernels themselves compile and run only on the card, so this is the check of
their compiled numerics at full depth, to run before any timing.

Tolerance: the two bf16 routes round different but equally valid
contraction orders, a relative L2 that grows with depth; a wrong mask, rope
or normalisation gives relative errors near 1, so ``REL_TOL`` 5e-2 rejects
kernel faults without failing on rounding. ``chip_smoke.py``'s ``[probes]``
phase prints the relative L2 measured on the H100.

    python -m lemas_tts_tpu_torch.scripts.kernel_check --ns 1024 --bs 1 8
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Sequence

import numpy as np
import torch

from lemas_tts_tpu_torch.scripts._probe_common import add_device_arg, random_dit

REL_TOL = 5e-2

FLAGSHIP_NS = (1024, 2048, 4096)
FLAGSHIP_BS = (1, 8)


def check_kernels(ns: Sequence[int] = FLAGSHIP_NS, bs: Sequence[int] = FLAGSHIP_BS,
                  rel_tol: float = REL_TOL, dtype: torch.dtype = torch.bfloat16,
                  device=None, arch=None, verbose: bool = True) -> list[dict]:
    """``vmem`` against ``xla`` DiT forwards (``arch``: the flagship unless
    given). Returns one record per (N, B); raises AssertionError on a
    tolerance violation."""
    from lemas_tts_tpu_torch.api import select_device
    from lemas_tts_tpu_torch.config import DiTArch

    device = select_device(device)
    arch = arch or DiTArch()
    vmem = random_dit(arch, 100, 898, device, "vmem", seed=11, dtype=dtype)
    xla = random_dit(arch, 100, 898, device, "xla", dtype=dtype, state=vmem.state_dict())

    def host(a, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    rng = np.random.default_rng(5)
    records = []
    for n in ns:
        for b in bs:
            x = host(rng.standard_normal((b, n, 100)))
            cond = host(rng.standard_normal((b, n, 100)))
            text = host(rng.integers(1, 800, (b, 256)).astype(np.int32), torch.int32)
            t = host(rng.uniform(0.05, 0.95, (b,)).astype(np.float32), torch.float32)
            # a ragged batch: the last row padded to half length, as in a bucket
            lens = np.full(b, n)
            if b > 1:
                lens[-1] = n // 2
            mask_np = np.arange(n)[None, :] < lens[:, None]
            mask = host(mask_np, torch.bool)
            with torch.no_grad():
                a = vmem(x, cond, text, t, mask).float().cpu().numpy()
                r = xla(x, cond, text, t, mask).float().cpu().numpy()
            m = mask_np[..., None]  # valid frames only (padded queries are zeroed by both)
            diff = (a - r) * m
            rel = float(np.linalg.norm(diff) / (np.linalg.norm(r * m) + 1e-12))
            rec = {"n": n, "batch": b, "rel_l2": round(rel, 5),
                   "max_abs": round(float(np.abs(diff).max()), 5), "ok": rel <= rel_tol}
            records.append(rec)
            if verbose:
                print(json.dumps(rec), file=sys.stderr)
            if not rec["ok"]:
                raise AssertionError(
                    f"kernel mismatch at N={n} B={b}: rel_l2={rel:.4g} > {rel_tol} on "
                    f"{device}: the vmem kernels disagree with the xla route; do not trust "
                    "timings of this build")
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ns", type=int, nargs="+", default=list(FLAGSHIP_NS))
    ap.add_argument("--bs", type=int, nargs="+", default=list(FLAGSHIP_BS))
    ap.add_argument("--rel_tol", type=float, default=REL_TOL)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from lemas_tts_tpu_torch.api import select_device

    device = select_device(args.device)
    records = check_kernels(args.ns, args.bs, args.rel_tol, getattr(torch, args.dtype), device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({"kernel_check": "ok", "device": name, "records": records}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
