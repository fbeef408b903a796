"""Measure approximation stacking on distilled students (counterpart of
``lemas_tts_tpu/scripts/student_stack_probe.py``).

The serving block cache (``config.SERVING_BLOCK_CACHE``) was chosen at NFE 32
with CFG; at student settings (K in {8, 16} steps, ``cfg_strength=0``,
guidance baked in; ``cfm/distill.py:student_sampler_settings``) a
refresh-every-2 cache is stale for more of the trajectory per refresh, and
there is no uncond pass for a cutoff to truncate. This probe runs the
block-cache grid (``blockcache_probe``) at the student settings, by default
at the wide-head 8 x 128 geometry, so a student sidecar's ``block_cache``
key (read by ``TTS.apply_student_settings``) comes from a measurement:

    python -m lemas_tts_tpu_torch.scripts.student_stack_probe \\
        --steps 8,16 --heads 8 --dim_head 128 --specs 0-22:2+t2,0-22:4

Per K it prints the blockcache records tagged ``student_nfe`` and a
``picked`` line: the fastest spec whose mel MSE (against that student's own
exact trajectory from the same noise) fits ``--pick_mse``; ``null`` means
none fits and the sidecar should leave the cache off.
"""

from __future__ import annotations

import argparse
import json

from lemas_tts_tpu_torch.config import SERVING_BLOCK_CACHE
from lemas_tts_tpu_torch.scripts._probe_common import add_device_arg


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=str, default="8,16", help="comma list of student NFE values")
    p.add_argument("--sway", type=float, default=1.0,
                   help="student sway warp (distill training grid)")
    p.add_argument("--specs", type=str,
                   default=",".join(dict.fromkeys([SERVING_BLOCK_CACHE, "0-22:2", "2-20:2"])),
                   help="block-cache specs to stack on the student")
    p.add_argument("--pick_mse", type=float, default=1e-4, help="mel-MSE budget for the pick")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--no_time", action="store_true")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--depth", type=int, default=22)
    p.add_argument("--heads", type=int, default=8,
                   help="student heads (default: the wide-head geometry)")
    p.add_argument("--dim_head", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mel_dim", type=int, default=100)
    p.add_argument("--vocab", type=int, default=898)
    p.add_argument("--text_dim", type=int, default=512)
    p.add_argument("--conv_layers", type=int, default=4)
    add_device_arg(p)
    return p


def run(args, model=None, inputs=None) -> list[dict]:
    """The block-cache grid per student NFE; ``model`` and ``inputs``
    default to ``probe_model_and_inputs`` (built once for every K)."""
    from lemas_tts_tpu_torch.scripts._probe_common import probe_model_and_inputs
    from lemas_tts_tpu_torch.scripts.blockcache_probe import run_probe

    out = []
    for k in (int(s) for s in args.steps.split(",") if s):
        sub = argparse.Namespace(
            nfe=k, cfg=0.0, sway=args.sway, cfg_cutoff=None, specs=args.specs,
            batch=args.batch, n=args.n, reps=args.reps, no_time=args.no_time, ckpt=args.ckpt,
            dim=args.dim, depth=args.depth, heads=args.heads, dim_head=args.dim_head,
            seed=args.seed, mel_dim=args.mel_dim, vocab=args.vocab, text_dim=args.text_dim,
            conv_layers=args.conv_layers, quant="", device=args.device,
            pick_mse=None)  # picked per K below, after tagging
        if model is None:
            model, inputs = probe_model_and_inputs(sub)
        print(json.dumps({"student_nfe": k, "heads": args.heads, "dim_head": args.dim_head}))
        recs = run_probe(sub, model, inputs)
        for r in recs:
            r["student_nfe"] = k
        ok = [r for r in recs if r["mel_mse"] <= args.pick_mse]
        pick = None
        if ok:
            key = ((lambda r: r["speedup"]) if not args.no_time
                   else (lambda r: -r["block_cost_ratio"]))
            pick = max(ok, key=key)["spec"]
        print(json.dumps({"student_nfe": k, "picked": pick, "pick_mse": args.pick_mse}))
        out.extend(recs)
    return out


def main(argv=None):
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
