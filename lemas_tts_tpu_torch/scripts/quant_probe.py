"""Int8-against-bf16 sampler divergence and speed probe (counterpart of
``lemas_tts_tpu/scripts/quant_probe.py``).

W8A8 int8 (``ops/quant.py``: per-token activation and per-channel weight
scales, ``torch._int_mm`` for the product) is the JAX package's serving
default (``config.SERVING_QUANT``). This probe measures both halves of that
choice on the card:

- quality: one exact-noise sampler run per dtype per mode (the exact
  semantics and the serving approximations: CFG cutoff and block cache),
  mel MSE and relative L2 between the int8 and bf16 trajectories, at both
  head geometries (flagship 16 x 64 and the wide-head 8 x 128 split);
- speed (``--speed``): best-of-``--reps`` card time of the sampler's CUDA
  graph replay per dtype at the probe shape.

Under ``int8`` the q/k/v, out and FF products are int8, so of the port's
kernels only the attention (K3) runs; under ``int8_ff`` K1 and K3 run.

    python -m lemas_tts_tpu_torch.scripts.quant_probe               # quality grid
    python -m lemas_tts_tpu_torch.scripts.quant_probe --speed       # + card time
"""

from __future__ import annotations

import argparse
import json
from types import SimpleNamespace

import numpy as np

from lemas_tts_tpu_torch.scripts._probe_common import add_device_arg


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default="", help="checkpoint (blank: random)")
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=22)
    ap.add_argument("--geometries", nargs="*", default=None,
                    help="HxD head splits to probe (default: 16x64 + 8x128 at the flagship "
                         "dim; just --heads/--dim_head when a model geometry is given)")
    ap.add_argument("--heads", type=int, default=None)
    ap.add_argument("--dim_head", type=int, default=None)
    ap.add_argument("--mel_dim", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--text_dim", type=int, default=None)
    ap.add_argument("--conv_layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--nfe", type=int, default=32)
    ap.add_argument("--cfg", type=float, default=2.0)
    ap.add_argument("--sway", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant", default="int8", choices=["int8", "int8_ff"],
                    help="quantization mode to probe against bf16")
    ap.add_argument("--speed", action="store_true",
                    help="also time the sampler per dtype (best of --reps graph replays)")
    ap.add_argument("--reps", type=int, default=3)
    add_device_arg(ap)
    return ap


def geometries(args) -> list:
    if args.geometries is not None:
        return [tuple(int(x) for x in s.split("x")) for s in args.geometries]
    if args.heads is not None:
        return [(args.heads, args.dim_head or args.dim // args.heads)]
    return [(16, 64), (8, 128)]


def mode_settings(args) -> dict:
    """``{mode: SamplerSettings}``: the exact sampler and the serving
    approximations (CFG cutoff, block cache clamped to the depth)."""
    from lemas_tts_tpu_torch.cfm.sampler import SamplerSettings, block_cache_fields
    from lemas_tts_tpu_torch.config import SERVING_BLOCK_CACHE, SERVING_CFG_CUTOFF

    base = dict(steps=args.nfe, cfg_strength=args.cfg, sway_sampling_coef=args.sway)
    return {"exact": SamplerSettings(**base),
            "serving": SamplerSettings(**base, cfg_cutoff=SERVING_CFG_CUTOFF,
                                       **block_cache_fields(SERVING_BLOCK_CACHE, args.depth))}


def run(args, models=None) -> list[dict]:
    """One record per (geometry, mode). ``models`` maps a geometry ``(H, D)``
    to ``(bf16 model, int8 model, inputs)`` (default: both built from the
    same weights by ``probe_model_and_inputs``)."""
    from lemas_tts_tpu_torch.cfm.graph import GraphPool
    from lemas_tts_tpu_torch.eval.metrics import mel_mse
    from lemas_tts_tpu_torch.scripts._probe_common import (make_sampler, measure,
                                                            probe_model_and_inputs)

    records = []
    for H, D in geometries(args):
        if models is not None:
            model, qmodel, inputs = models[(H, D)]
        else:
            ns = SimpleNamespace(ckpt=args.ckpt or None, dim=args.dim, depth=args.depth,
                                 heads=H, dim_head=D, seed=args.seed, batch=args.batch, n=args.n,
                                 mel_dim=args.mel_dim, vocab=args.vocab, text_dim=args.text_dim,
                                 conv_layers=args.conv_layers, device=args.device)
            model, inputs = probe_model_and_inputs(ns)
            qmodel, _ = probe_model_and_inputs(SimpleNamespace(**vars(ns), quant=args.quant))
        device = inputs[0].device
        pool = GraphPool()
        for tag, st in mode_settings(args).items():
            runs = {name: make_sampler(m, st, inputs, pool, graph=args.speed)
                    for name, m in (("bf16", model), ("int8", qmodel))}
            out = {name: measure(fn, device, args.reps, timed=args.speed)
                   for name, fn in runs.items()}
            mf, mq = out["bf16"][0], out["int8"][0]
            rec = {"geometry": f"h{H}d{D}", "mode": tag, "quant": args.quant,
                   "mel_mse_int8_vs_bf16": float(mel_mse(mq, mf)),
                   "rel_l2": round(float(np.linalg.norm(mq - mf) / np.linalg.norm(mf)), 6)}
            if args.speed:
                for name in runs:
                    rec[f"{name}_wall_s"] = round(out[name][1], 4)
                rec["speedup"] = round(rec["bf16_wall_s"] / rec["int8_wall_s"], 4)
            records.append(rec)
            print(json.dumps(rec))
    return records


def main(argv=None) -> int:
    run(build_argparser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
