"""Measure the block-range residual cache's speed/quality trade
(counterpart of ``lemas_tts_tpu/scripts/blockcache_probe.py``).

``SamplerSettings.block_cache_range`` (``cfm/sampler.py``) is the
training-free DiT acceleration of the DeepCache/Δ-DiT family: on refresh
steps the whole stack runs and the aggregate residual of blocks ``[lo, hi)``
is stored; on the other steps that range is one cached add. The reference
(``lemas_tts/model/cfm.py:382-425``) pays every block on every step.

For a grid of (range, refresh period) specs it measures:

- speed: the analytic block-cost ratio (host math) and the card-time
  speedup against the uncached sampler on the same shapes (CUDA graph
  replays timed with CUDA events, best of ``--reps``);
- quality: mel MSE / MCD / relative L2 against the uncached trajectory from
  the same noise, reference frames and text (random weights by default: a
  trajectory-divergence scale, not a perceptual score).

    python -m lemas_tts_tpu_torch.scripts.blockcache_probe \\
        --nfe 32 --cfg 2.0 --sway 1.0 --specs 2-14:2,2-20:3+t6
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from lemas_tts_tpu_torch.scripts.cutoff_probe import add_geometry_args


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nfe", type=int, default=32)
    p.add_argument("--cfg", type=float, default=2.0)
    p.add_argument("--sway", type=float, default=1.0)
    p.add_argument("--cfg_cutoff", type=float, default=None,
                   help="compose with CFG truncation (serving default 0.5)")
    p.add_argument("--specs", type=str, default="2-14:2,6-18:2,4-20:2,4-20:3",
                   help="comma-separated block-cache specs ('lo-hi:every[+hN][+tN]', "
                        "parse_block_cache)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n", type=int, default=1024, help="mel-frame bucket")
    p.add_argument("--reps", type=int, default=3,
                   help="timing repetitions (best-of, after the capture)")
    p.add_argument("--no_time", action="store_true", help="skip timing (quality only)")
    add_geometry_args(p)
    p.add_argument("--quant", type=str, default="",
                   help="probe at a W8A8 serving dtype ('int8'/'int8_ff'; blank = bf16)")
    p.add_argument("--pick_mse", type=float, default=None,
                   help="also print the fastest probed spec whose mel MSE is within this "
                        "budget")
    return p


def cache_settings(args, spec):
    """``SamplerSettings`` of the probe at block-cache ``spec`` (None: off),
    clamped to the probe's depth."""
    from lemas_tts_tpu_torch.cfm.sampler import SamplerSettings, block_cache_fields

    return SamplerSettings(steps=args.nfe, cfg_strength=args.cfg, sway_sampling_coef=args.sway,
                           cfg_cutoff=args.cfg_cutoff, **block_cache_fields(spec, args.depth))


def block_cost_ratio(settings, depth: int) -> float:
    """Average blocks a velocity call runs over ``depth``, from the real
    refresh schedule: the warm head and tail and the forced refresh where
    CFG truncation halves the width."""
    from lemas_tts_tpu_torch.cfm.sampler import block_cache_flags, sway_time_grid

    steps = settings.steps
    flags = block_cache_flags(settings, steps)
    k = settings.cfg_active_steps(sway_time_grid(steps, settings.sway_sampling_coef))
    if settings.use_cfg and k < steps:
        flags[k] = True
    lo, hi = settings.block_cache_range
    skipped = (hi - lo) * float(np.mean(~flags))
    return round((depth - skipped) / depth, 4)


def run_probe(args, model=None, inputs=None) -> list[dict]:
    """One record per spec, then the uncached line (and ``picked`` with
    ``--pick_mse``); ``model`` and ``inputs`` default to
    ``probe_model_and_inputs(args)``."""
    from lemas_tts_tpu_torch.cfm.graph import GraphPool
    from lemas_tts_tpu_torch.eval.metrics import mcd, mel_mse
    from lemas_tts_tpu_torch.scripts._probe_common import (make_sampler, measure,
                                                            probe_model_and_inputs)

    if model is None:
        model, inputs = probe_model_and_inputs(args)
    device = inputs[0].device
    ref = min(188, args.n // 4)
    pool = GraphPool()  # the probe's graphs run one at a time: one workspace

    def run(settings):
        return measure(make_sampler(model, settings, inputs, pool), device, args.reps,
                       timed=not args.no_time)

    full, t_full = run(cache_settings(args, None))
    scale = float(np.mean(np.square(full)))
    records = []
    for spec in (s for s in args.specs.split(",") if s):
        settings = cache_settings(args, spec)
        if settings.block_cache_range is None:
            # the spec clamps to nothing at this depth: a no-op run
            print(json.dumps({"spec": spec, "disabled": True}))
            continue
        mel, t = run(settings)
        err = float(mel_mse(mel, full))
        # MCD (dB) on the generated region: a cepstral view of the same deviation
        mcd_db = float(np.mean([mcd(mel[i, ref:], full[i, ref:]) for i in range(len(mel))]))
        rec = {
            "spec": spec,
            "block_cost_ratio": block_cost_ratio(settings, args.depth),
            "mel_mse": err,
            "mcd_db": round(mcd_db, 4),
            "rel_l2": round(float(np.sqrt(err / max(scale, 1e-20))), 6),
            "time_s": round(t, 4),
            "speedup": round(t_full / t, 4) if not args.no_time else None,
        }
        records.append(rec)
        print(json.dumps(rec))
    print(json.dumps({"spec": "none", "time_s": round(t_full, 4), "speedup": 1.0,
                      "mel_mse": 0.0}))
    if args.pick_mse is not None:
        ok = [r for r in records if r["mel_mse"] <= args.pick_mse]
        key = ((lambda r: r["speedup"]) if not args.no_time
               else (lambda r: -r["block_cost_ratio"]))
        pick = max(ok, key=key) if ok else None
        print(json.dumps({"picked": pick["spec"] if pick else None,
                          "budget_mse": args.pick_mse}))
    return records


def main(argv=None):
    run_probe(build_argparser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
