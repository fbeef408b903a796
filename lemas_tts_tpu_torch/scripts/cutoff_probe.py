"""Measure the cfg_cutoff speed/quality trade on fixed noise (counterpart of
``lemas_tts_tpu/scripts/cutoff_probe.py``).

The opt-in ``cfg_cutoff`` (``cfm/sampler.py:SamplerSettings.cfg_cutoff``)
skips the unconditional half of the CFG forward once the reference's
decaying scale ``cfg_strength·(1−t)²`` (``lemas_tts/model/cfm.py:420``)
falls below the threshold. How much that saves depends on the sway warp: the
canonical CLI grid (NFE 64, sway 3, ``t**4``) is front-loaded, so most steps
sit at small ``t`` where the scale is near full. This probe measures both
sides of the trade on one command:

- speed: the active-step count (host math) and the implied model-forward
  cost ratio against full CFG;
- quality: mel MSE / relative L2 of the truncated trajectory against the
  full-CFG trajectory from the same noise, reference frames and text.

It runs at flagship geometry on the card by default (random weights: the
deviation is a trajectory-divergence scale, not a perceptual score;
``--ckpt`` loads a reference checkpoint). ``--dim/--depth/--heads`` shrink it,
``--device cpu`` runs it on the CPU.

    python -m lemas_tts_tpu_torch.scripts.cutoff_probe --nfe 64 --cfg 5.0 \\
        --sway 3.0 --cutoffs 0.25,1.0,2.0
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from lemas_tts_tpu_torch.scripts._probe_common import add_device_arg


def add_geometry_args(p, heads: int = 16, dim_head=None) -> None:
    """The probe-geometry flags every sampler probe shares."""
    p.add_argument("--ckpt", type=str, default=None,
                   help="optional reference checkpoint (.pt/.safetensors)")
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--depth", type=int, default=22)
    p.add_argument("--heads", type=int, default=heads)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mel_dim", type=int, default=100,
                   help="mel channels (non-flagship checkpoints)")
    p.add_argument("--vocab", type=int, default=898,
                   help="text_num_embeds (non-flagship checkpoints)")
    p.add_argument("--dim_head", type=int, default=dim_head,
                   help="head dim (default: flagship 64, or dim//heads for small probes; "
                        "128 probes the wide-head student geometry)")
    p.add_argument("--text_dim", type=int, default=512)
    p.add_argument("--conv_layers", type=int, default=4)
    add_device_arg(p)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nfe", type=int, default=64)
    p.add_argument("--cfg", type=float, default=5.0)
    p.add_argument("--sway", type=float, default=3.0,
                   help="sway coefficient (canonical CLI: 3.0; serving: 1.0)")
    p.add_argument("--cutoffs", type=str, default="0.25,1.0,2.0",
                   help="comma-separated cfg_cutoff values to probe")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--n", type=int, default=1024, help="mel-frame bucket")
    add_geometry_args(p)
    p.add_argument("--quant", type=str, default="",
                   help="probe at a W8A8 serving dtype ('int8'/'int8_ff'; blank = bf16 — "
                        "specs chosen at bf16 should be re-validated under int8)")
    return p


def run_probe(args, model=None, inputs=None) -> list[dict]:
    """One record per cutoff; ``model`` and ``inputs`` default to
    ``probe_model_and_inputs(args)``."""
    from lemas_tts_tpu_torch.cfm.sampler import SamplerSettings, sway_time_grid
    from lemas_tts_tpu_torch.eval.metrics import mel_mse
    from lemas_tts_tpu_torch.scripts._probe_common import (make_sampler, measure,
                                                            probe_model_and_inputs)

    if model is None:
        model, inputs = probe_model_and_inputs(args)
    device = inputs[0].device
    grid = sway_time_grid(args.nfe, args.sway)

    def sample(cutoff):
        s = SamplerSettings(steps=args.nfe, cfg_strength=args.cfg,
                            sway_sampling_coef=args.sway, cfg_cutoff=cutoff)
        mel, _ = measure(make_sampler(model, s, inputs, graph=False), device, timed=False)
        return mel, s.cfg_active_steps(grid)

    full, total = sample(None)
    scale = float(np.mean(np.square(full)))
    records = []
    for cutoff in (float(c) for c in args.cutoffs.split(",") if c):
        mel, active = sample(cutoff)
        err = float(mel_mse(mel, full))
        rec = {
            "cutoff": cutoff,
            "active_steps": active,
            "total_steps": total,
            # model forwards: 2 per CFG step, 1 per truncated step
            "fwd_cost_ratio": round((2 * active + (total - active)) / (2 * total), 4),
            "mel_mse": err,
            "rel_l2": round(float(np.sqrt(err / max(scale, 1e-20))), 6),
            "max_abs": round(float(np.max(np.abs(mel - full))), 6),
        }
        records.append(rec)
        print(json.dumps(rec))
    return records


def main(argv=None):
    run_probe(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
