"""Trace the flagship sampler on the card and summarise it (counterpart of
``lemas_tts_tpu/scripts/profile_sampler.py``).

Runs the flagship CFM/DiT sampler on random weights (its speed does not
depend on them) as a CUDA graph (``cfm/graph.py``): the first call captures,
a second replay is timed with CUDA events, and a third runs under
``torch.profiler``. It prints the top kernels by card time, the card's busy
time (the union of kernel intervals), its idle share of the profiled call,
and the model FLOP utilisation::

    mfu = sampler_call_flops / card busy / device_peak_flops

(``utils/flops.py``). The profiler slows a replay, so the profiled idle
share is an upper bound; busy time is the card's own work.

    python -m lemas_tts_tpu_torch.scripts.profile_sampler --batch 1 --nfe 32
    python -m lemas_tts_tpu_torch.scripts.profile_sampler --logdir trace/ --top 30
    python -m lemas_tts_tpu_torch.scripts.profile_sampler --summarize trace/sampler.json

``--device cpu`` runs the sampler eagerly on the CPU (no graph, no busy
time, no mfu) and summarises the host operators; ``profile(args, arch)``
takes a smaller model there.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from lemas_tts_tpu_torch.scripts._probe_common import add_device_arg, make_sampler, random_dit, \
    seconds
from lemas_tts_tpu_torch.utils.profiling import summarize_trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--nfe", type=int, default=32)
    p.add_argument("--frames", type=int, default=1024, help="mel-frame bucket (sequence length)")
    p.add_argument("--text_len", type=int, default=256)
    p.add_argument("--logdir", type=str, default=None,
                   help="keep the Chrome trace here as sampler.json (default: not kept)")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--summarize", type=str, default=None, metavar="TRACE_JSON",
                   help="only summarise an existing Chrome trace and exit")
    p.add_argument("--quant", type=str, default="",
                   help="profile the W8A8 serving dtype ('int8'/'int8_ff'; blank = bf16)")
    add_device_arg(p)
    return p


def profile(args, arch=None) -> dict:
    """The sampler's record: a replay's time, and on CUDA busy, idle share,
    FLOPs and mfu of the profiled replay. ``arch``: the flagship's unless
    given (smaller for a CPU run)."""
    from lemas_tts_tpu_torch.api import select_device
    from lemas_tts_tpu_torch.cfm.sampler import SamplerSettings
    from lemas_tts_tpu_torch.config import DiTArch
    from lemas_tts_tpu_torch.utils.flops import device_peak_flops, sampler_call_flops
    from lemas_tts_tpu_torch.utils.profiling import profile_card

    device = select_device(args.device)
    arch = arch or DiTArch()
    model = random_dit(arch, 100, 898, device, quant=args.quant or None)

    rng = np.random.default_rng(0)
    B, N, nt = args.batch, args.frames, args.text_len
    text = rng.integers(1, 800, (B, nt)).astype(np.int32)
    ref = min(188, N // 4)
    cond = np.zeros((B, N, 100), np.float32)
    cond[:, :ref] = rng.standard_normal((B, ref, 100)) * 0.5 - 5.0
    cond_mask = np.zeros((B, N), bool)
    cond_mask[:, :ref] = True
    inputs = tuple(torch.from_numpy(a).to(device) for a in (
        cond, cond_mask, text, np.full(B, N, np.int64),
        rng.standard_normal((B, N, 100)).astype(np.float32)))
    settings = SamplerSettings(steps=args.nfe, cfg_strength=2.0, sway_sampling_coef=1.0)
    run = make_sampler(model, settings, inputs)
    run()  # on CUDA: the eager run and the capture
    wall = seconds(run, device)
    flops = sampler_call_flops(arch, settings, B, N)
    rec = {"batch": B, "frames": N, "nfe": args.nfe, "quant": args.quant or None,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "time_ms": round(wall * 1e3, 3), "ms_per_step": round(wall / args.nfe * 1e3, 4),
           "tflop": round(flops / 1e12, 4)}
    trace = os.path.join(args.logdir, "sampler.json") if args.logdir else None
    if trace:
        os.makedirs(args.logdir, exist_ok=True)
    if device.type == "cuda":
        prof = profile_card(run, trace)
        peak = device_peak_flops(device)
        rec.update(busy_ms=round(prof["busy_ms"], 3), wall_ms=round(prof["wall_ms"], 3),
                   idle=round(prof["idle"], 4), kernels=prof["kernels"],
                   mfu=round(flops / (prof["busy_ms"] / 1e3) / peak, 4) if peak else None)
        rec["top"] = [[round(us / 1e3, 3), n, name[:110]] for us, n, name in
                      prof["rows"][:args.top]]
    elif trace:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
        prof.export_chrome_trace(trace)
    if trace:
        rec["trace"] = trace
    return rec


def main(argv=None, arch=None) -> int:
    args = build_parser().parse_args(argv)
    if args.summarize:
        print(summarize_trace(args.summarize, args.top))
        return 0
    rec = profile(args, arch)
    for ms, n, name in rec.get("top", []):
        print(f"{ms:9.3f} ms  n={n:>5}  {name}")
    if rec.get("trace") and "top" not in rec:
        print(summarize_trace(rec["trace"], args.top))
    print(json.dumps({k: v for k, v in rec.items() if k != "top"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
