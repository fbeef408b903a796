"""Wide-head geometry probe: 16 x 64 (the flagship) against 8 x 128
(counterpart of ``lemas_tts_tpu/scripts/widehead_probe.py``).

At the same ``dim = heads * dim_head = 1024`` the q/k/v and out projections
and the parameter count are the same, so an 8 x 128 model is a candidate
student geometry for distillation (``cfm/distill.py``), not a drop-in for
reference checkpoints. The flat attention kernel (K3,
``csrc/attention_nhd.cu``) takes both: d64 heads in pairs, d128 heads one a
block, with half as many softmax rows.

Two measurements (a kernel's standalone gain can vanish end to end, so both
are reported):

1. standalone: K3 at both geometries on the same q/k/v, card time per call
   (``utils/profiling.py:device_ms``);
2. e2e: the CFM sampler's card time (a CUDA graph replay, best of
   ``--reps_e2e``) of a flagship-width random-weight DiT at both geometries,
   in audio seconds per second.

    python -m lemas_tts_tpu_torch.scripts.widehead_probe            # both parts
    python -m lemas_tts_tpu_torch.scripts.widehead_probe --no_e2e   # kernel only
"""

from __future__ import annotations

import argparse
import json
from types import SimpleNamespace

import torch

from lemas_tts_tpu_torch.scripts._probe_common import add_device_arg, attention_inputs, call_us

SR, HOP = 24000, 256  # audio seconds at the flagship's mel rate


def geometries(dim: int) -> tuple:
    """(heads, dim_head) of the d64 and d128 splits of ``dim`` (16 x 64 and
    8 x 128 at the flagship's 1024)."""
    return (dim // 64, 64), (dim // 128, 128)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="*", default=["8x1024", "1x1024", "2x2048", "1x4096"])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--reps_e2e", type=int, default=3)
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=22)
    ap.add_argument("--nfe", type=int, default=32)
    ap.add_argument("--cfg", type=float, default=2.0)
    ap.add_argument("--sway", type=float, default=1.0)
    ap.add_argument("--cfg_cutoff", type=float, default=None)
    ap.add_argument("--block_cache", type=str, default="",
                    help="optional serving spec, e.g. 0-22:2+t2")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no_standalone", action="store_true")
    ap.add_argument("--no_e2e", action="store_true")
    add_device_arg(ap)
    return ap


def standalone(args) -> list[dict]:
    """K3 at both geometries on each B x N shape: microseconds a call."""
    from lemas_tts_tpu_torch.api import select_device
    from lemas_tts_tpu_torch.ops.attention import vmem_attention_nhd
    from lemas_tts_tpu_torch.ops.rope import rope_angles

    device = select_device(args.device)
    dt = torch.bfloat16 if device.type == "cuda" else torch.float32
    records = []
    for spec in args.shapes:
        B, N = (int(x) for x in spec.split("x"))
        q, k, v, mask = attention_inputs(B, N, args.dim, dt, device)
        times = {}
        for H, D in geometries(args.dim):
            ang = rope_angles(N, D, device=device)
            with torch.no_grad():
                times[D] = call_us(lambda: vmem_attention_nhd(q, k, v, mask, ang, heads=H),
                                   device, args.reps)
        rec = {"shape": spec, "d64_us": round(times[64], 2), "d128_us": round(times[128], 2),
               "speedup": round(times[64] / times[128], 3)}
        records.append(rec)
        print(json.dumps(rec))
    return records


def e2e(args, models=None) -> dict:
    """The sampler at both geometries; ``models`` maps ``(H, D)`` to
    ``(model, inputs)`` (default: ``probe_model_and_inputs``)."""
    from lemas_tts_tpu_torch.cfm.graph import GraphPool
    from lemas_tts_tpu_torch.cfm.sampler import SamplerSettings, block_cache_fields
    from lemas_tts_tpu_torch.scripts._probe_common import (make_sampler, measure,
                                                            probe_model_and_inputs)

    B, N = args.batch, args.n
    ref = min(188, N // 4)
    audio_sec = B * (N - ref - 1) * HOP / SR
    settings = SamplerSettings(steps=args.nfe, cfg_strength=args.cfg,
                               sway_sampling_coef=args.sway, cfg_cutoff=args.cfg_cutoff,
                               **block_cache_fields(args.block_cache or None, args.depth))
    results = {}
    for H, D in geometries(args.dim):
        if models is not None:
            model, inputs = models[(H, D)]
        else:
            model, inputs = probe_model_and_inputs(SimpleNamespace(
                ckpt=None, dim=args.dim, depth=args.depth, heads=H, dim_head=D, seed=args.seed,
                batch=B, n=N, device=args.device))
        _, best = measure(make_sampler(model, settings, inputs, GraphPool()), inputs[0].device,
                          args.reps_e2e)
        results[D] = best
        print(json.dumps({"geometry": f"h{H}d{D}", "sampler_wall_s": round(best, 4),
                          "audio_s_per_s": round(audio_sec / best, 2)}))
        del model
    rec = {"e2e_speedup_d128_vs_d64": round(results[64] / results[128], 4), "nfe": args.nfe,
           "batch": B, "n": N, "cfg_cutoff": args.cfg_cutoff, "block_cache": args.block_cache}
    print(json.dumps(rec))
    return rec


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if not args.no_standalone:
        standalone(args)
    if not args.no_e2e:
        e2e(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
