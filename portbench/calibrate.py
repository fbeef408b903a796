"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

For a cell and a list of seeds, each seed's weights and request pool: the
cell's check sample (the longest request and ``check.requests - 1`` drawn
from the seed) made once by the plain reference, and served by each
variant, batched as the window batches it, and compared as a run compares
it:

- ``program``: the program as the cell runs it (the lower reading);
- ``program-int8``: the program with its own W8A8 int8 path on, the
  control of a bfloat16 cell;
- ``reference-fp8``: the reference with every product of the backbone and of
  the vocoder in float8 e4m3 put in the program's place (the families'
  ``quantize_all``), the control of the
  stages that the int8 path leaves in bfloat16 (the vocoder);
- ``reference-int4``: the reference with W4A4 block products put in the
  program's place (the backbone family's ``quantize_blocks``), the control of
  a W8A8 cell (int4 for int8).

``program`` runs on every seed of ``--seeds``, the other variants on
``--control-seeds``. Witnesses of where a wave gap comes from, printed with
the program's readings: ``wave_full_rel_l2``, the served wave against the
reference's whole request; ``wave_from_mel_gap``, the reference's vocoder
on the served mel against it on the reference's own mel (the mel gap as an
exact vocoder carries it into the wave); ``wave_alone_rel_l2``, the served
wave against the program's own vocoder decoding each served chunk mel alone,
unpadded and unmasked, through the reference's RMS restore and cross-fade.

    python3 -m portbench.calibrate --workload multilingual.single-1chunk \\
        --variants program program-int8 reference-fp8 --seeds 11 12 13 \\
        --control-seeds 11

Prints one JSON line per seed and variant and a summary line per variant of
the smallest and largest reading of each number. Each program is built once;
each seed's weights are copied into it in place, so the captured graphs stay
valid.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from portbench import check, system, weights
from portbench import traffic as gen
from portbench.reference import request as ref
from portbench.spec import Bench


def sample(pool: List[gen.Request], k: int, seed: int) -> List[gen.Request]:
    """The longest request and ``k - 1`` others drawn from the seed."""
    order = sorted(pool, key=lambda r: -max(r.durations))
    rng = np.random.default_rng(gen.mix(seed, "calibrate"))
    rest = order[1:]
    take = rng.choice(len(rest), min(k - 1, len(rest)), replace=False)
    return [order[0]] + [rest[int(i)] for i in take]


def reload(sysm: system.System, cell, seed: int) -> None:
    """The seed's weights copied into the built system, quantizing where the
    model holds W8A8 products."""
    from lemas_tts_tpu_torch.ops.quant import QuantLinear, quantize_weight

    w = system.make_weights(cell, seed, sysm.device)
    with torch.no_grad():
        for key, model in (("backbone", sysm.synth.dit_model),
                           ("vocoder", sysm.synth.vocoder_model)):
            mods = dict(model.named_modules())
            for name, t in w[key].items():
                owner, _, attr = name.rpartition(".")
                m = mods[owner]
                if isinstance(m, QuantLinear) and attr == "weight":
                    wq, s = quantize_weight(t.float())
                    m.weight_q.copy_(wq)
                    m.scale.copy_(s)
                else:
                    getattr(m, attr).copy_(t)
    sysm.host_weights = {k: {n: v.cpu() for n, v in d.items()} for k, d in w.items()}


def serve_program(sysm, reqs: List[gen.Request], traffic: dict) -> list:
    """The sample through the cell's entry: all submitted to the engine at
    once (serving), or one ``synthesize_chunks`` call each."""
    if traffic["entry"] == "single":
        return [sysm.synth.synthesize_chunks(r.ref_wav, r.ref_sr, r.ref_text, r.chunks,
                                             cfg=sysm.cfg, seed=r.seed) for r in reqs]
    from lemas_tts_tpu_torch.serve.engine import ServingEngine, TTSRequest
    from lemas_tts_tpu_torch.utils.profiling import JsonLogger

    from portbench.drive import Lines

    srv = traffic["server"]
    engine = ServingEngine(sysm.synth, cfg=sysm.cfg, max_batch=int(srv["max_batch"]),
                           max_wait_ms=float(srv["max_wait_ms"]),
                           logger=JsonLogger(stream=Lines()))
    try:
        futs = [engine.submit(TTSRequest(r.ref_wav, r.ref_sr, r.ref_text, r.chunks[0],
                                         seed=r.seed)) for r in reqs]
        return [f.result(timeout=600) for f in futs]
    finally:
        engine.shutdown()


def witnesses(sysm, outs, refs, model, traffic) -> Dict[str, float]:
    """Where the program's wave gap comes from (see the module's head)."""
    s, chunked = check.sampler(traffic), traffic["entry"] == "single"
    voc = sysm.synth.vocoder_model
    out = {"wave_full_rel_l2": 0.0, "wave_from_mel_gap": 0.0, "wave_alone_rel_l2": 0.0}
    with check.exact_float32(), torch.no_grad():
        for (w, _, mel), (mels_ref, rms) in zip(outs, refs):
            cuts = np.cumsum([m.shape[1] for m in mels_ref])[:-1]
            parts = np.split(mel, cuts, axis=1)
            full = ref.vocode(model, s, mels_ref, rms, sysm.device, chunked)
            served = ref.vocode(model, s, parts, rms, sysm.device, chunked)
            own = [voc.decode(torch.from_numpy(np.ascontiguousarray(m, np.float32))[None]
                              .to(sysm.device)).float()[0].cpu().numpy() for m in parts]
            own = ref.finish(s, own, rms, model.mel["target_sample_rate"], chunked)
            for k, v in (("wave_full_rel_l2", check.rel_l2(w, full)),
                         ("wave_from_mel_gap", check.rel_l2(served, full)),
                         ("wave_alone_rel_l2", check.rel_l2(w, own))):
                out[k] = max(out[k], v)
    return out


def serve(cell, variant, systems, reqs, device) -> list:
    """The sample's outputs ``(wave, sr, mel)`` under ``variant``."""
    if variant.startswith("reference-"):
        fmt = {"reference-int4": 4, "reference-fp8": "fp8"}[variant]
        control = check.reference_model(cell, systems["program"].host_weights, device, fmt)
        s, chunked = check.sampler(cell.traffic), cell.traffic["entry"] == "single"
        with check.exact_float32():
            return [ref.synthesize(control, s, r.ref_wav, r.ref_sr, r.ref_text, r.chunks,
                                   r.seed, device, chunked) for r in reqs]
    return serve_program(systems[variant], reqs, cell.traffic)


def readings(cell, cfg_file: Path, systems: dict, seed: int, variants: List[str],
             device) -> Dict[str, Dict[str, float]]:
    """``{variant: numbers}`` of ``seed``'s check sample: the programs in
    ``systems`` (built on the first seed, reloaded on the others), the
    reference made once."""
    pool = gen.pool(cell.traffic, seed)
    builds = {"program": cell.traffic, "program-int8": dict(cell.traffic, quant="int8")}
    for name in ["program"] + [v for v in variants if v == "program-int8"]:
        if name not in systems:
            systems[name] = system.build(cell, builds[name], cfg_file, seed, device)
            system.warm(systems[name], pool, builds[name])
        else:
            reload(systems[name], cell, seed)
    reqs = sample(pool, int(cell.traffic["check"]["requests"]), seed)
    bits = {"int8": 8}.get(cell.traffic.get("quant"))
    model = check.reference_model(cell, systems["program"].host_weights, device, bits)
    refs = check.reference(reqs, model, cell.traffic, device)
    out = {}
    for variant in variants:
        outs = serve(cell, variant, systems, reqs, device)
        nums = check.numbers(outs, refs, model, cell.traffic, device)
        if variant == "program" and not nums["frames_off"]:
            nums.update(witnesses(systems["program"], outs, refs, model, cell.traffic))
        out[variant] = nums
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--variants", nargs="+", default=["program"],
                   choices=("program", "program-int8", "reference-fp8", "reference-int4"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    root = Path.cwd()
    bench = Bench(root)
    cell = bench.cell(args.workload)
    cfg_file = root / next(c["file"] for c in bench.doc["configs"]
                           if c["name"] == cell.config_name)
    dev = torch.device("cuda")
    system.build_kernels(dev)
    systems: Dict[str, system.System] = {}
    rows: Dict[str, list] = {}
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.perf_counter()
        todo = [v for v in args.variants
                if (seed in args.seeds if v == "program" else seed in args.control_seeds)]
        for variant, nums in readings(cell, cfg_file, systems, seed, todo, dev).items():
            rows.setdefault(variant, []).append(nums)
            print(json.dumps({"workload": cell.name, "variant": variant, "seed": seed,
                              "seconds": round(time.perf_counter() - t0, 1), **nums}),
                  flush=True)
    for variant, got in rows.items():
        summary = {k: [min(r[k] for r in got), max(r[k] for r in got)] for k in got[0]}
        print(json.dumps({"workload": cell.name, "variant": variant, "seeds": len(got),
                          "device": torch.cuda.get_device_name(dev), "min_max": summary}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
