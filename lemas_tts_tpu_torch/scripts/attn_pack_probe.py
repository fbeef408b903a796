"""Standalone probe: the head-pair-packed flat attention kernel (K4) against
the per-head one (K3) (counterpart of
``lemas_tts_tpu/scripts/attn_pack_probe.py``).

``ops/attention.vmem_attention_nhd`` (K3, ``csrc/attention_nhd.cu``) and its
``pack_pair=True`` variant (K4, the same file's head-pair entry) compute the
same function; K4 gives two d64 heads one kernel block. The probe first
checks that K4 equals K3 bit for bit at each shape, then times both on the
card (``utils/profiling.py:device_ms``: ``--reps`` calls queued behind a
spin, timed with CUDA events). One JSON record a shape.

    python -m lemas_tts_tpu_torch.scripts.attn_pack_probe --shapes 8x1024 1x1024
"""

from __future__ import annotations

import argparse
import json

import torch

from lemas_tts_tpu_torch.scripts._probe_common import add_device_arg, attention_inputs, call_us


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="*", default=["8x1024", "1x1024", "2x2048", "1x4096"],
                    help="BxN list (flagship heads=16, d=64)")
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--dtype", default="bfloat16")
    add_device_arg(ap)
    return ap


def run(args) -> list[dict]:
    """One record a shape: K4 bit-equal to K3 (else AssertionError), then
    both timed."""
    from lemas_tts_tpu_torch.api import select_device
    from lemas_tts_tpu_torch.ops.attention import vmem_attention_nhd
    from lemas_tts_tpu_torch.ops.rope import rope_angles

    device = select_device(args.device)
    dt = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    H, D = args.heads, 64
    records = []
    for spec in args.shapes:
        B, N = (int(x) for x in spec.split("x"))
        q, k, v, mask = attention_inputs(B, N, H * D, dt, device)
        ang = rope_angles(N, D, device=device)

        def base():
            return vmem_attention_nhd(q, k, v, mask, ang, heads=H)

        def packed():
            return vmem_attention_nhd(q, k, v, mask, ang, heads=H, pack_pair=True)

        with torch.no_grad():
            b, p = base().float(), packed().float()
            equal = bool(torch.equal(b, p))
            rel = float(torch.linalg.norm(p - b) / torch.linalg.norm(b).clamp_min(1e-30))
            if not equal:
                raise AssertionError(f"K4 differs from K3 at B={B} N={N}: rel_l2={rel:.3e}")
            t_base = call_us(base, device, args.reps)
            t_pack = call_us(packed, device, args.reps)
        rec = {"shape": spec, "base_us": round(t_base, 2), "packed_us": round(t_pack, 2),
               "speedup": round(t_base / t_pack, 3), "bit_equal": equal, "rel_l2": rel}
        records.append(rec)
        print(json.dumps(rec))
    return records


def main(argv=None) -> int:
    run(build_argparser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
