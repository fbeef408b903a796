"""``correct``: a sample of the window's finished requests worked out again
by the plain reference, after the window has closed and the program's state
is freed, and each number compared beside its limit.

The sample (``check.requests`` of the traffic file) is drawn from the seed
among the requests that finished, and always holds the longest. For each,
the reference makes the request again from its inputs and the benchmark's
weights. The numbers, each the widest over the sample:

- ``mel_rel_l2``: the served mel against the reference's (reference prep,
  text, durations, noise, every sampler step and the backbone);
- ``wave_rel_l2``: the served wave against the reference's vocoder, RMS
  restore, cross-fade and clip applied to the served mel, so that it holds
  the stages after the mel on their own (a mel gap of under 1 % reads as
  several % in a wave vocoded from it);
- ``frames_off``: the frames and samples by which the outputs' lengths
  differ (and 1 for another sample rate or mel width);
- ``failed_requests`` (set by the run): requests that failed or never came.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from portbench import traffic as gen
from portbench.reference import request as ref


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32: TF32 off for the reference."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def pick(records, k: int, seed: int) -> list:
    """``k`` finished requests drawn from the seed, the longest first."""
    ok = [r for r in records if r.ok]
    if not ok:
        return []
    longest = max(ok, key=lambda r: r.out[2].shape[1])
    rest = [r for r in ok if r is not longest]
    rng = np.random.default_rng(gen.mix(seed, "check"))
    idx = rng.choice(len(rest), min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(i)] for i in idx]


def reference_model(cell, host_weights: Dict[str, Dict[str, torch.Tensor]], device,
                    quant=None) -> ref.Model:
    """The reference of ``cell``'s configuration, by its families, on
    ``device`` with the benchmark's weights in float32 (``quant``: as
    ``reference.request.Model`` takes it)."""
    return ref.Model(cell.config, cell.backbone, cell.vocoder,
                     {k: v.to(device).float() for k, v in host_weights["backbone"].items()},
                     {k: v.to(device).float() for k, v in host_weights["vocoder"].items()},
                     quant)


def sampler(traffic: dict) -> ref.Sampler:
    return ref.Sampler(**traffic["sampler"])


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) /
                 max(np.linalg.norm(want), 1e-30))


def reference(reqs: List[gen.Request], model: ref.Model, traffic: dict, device) -> list:
    """The reference's ``(chunk mels, RMS)`` of each request."""
    s, chunked = sampler(traffic), traffic["entry"] == "single"
    with exact_float32():
        return [ref.generate(model, s, r.ref_wav, r.ref_sr, r.ref_text, r.chunks, r.seed,
                             device, chunked) for r in reqs]


def numbers(outs: list, refs: list, model: ref.Model, traffic: dict,
            device) -> Dict[str, float]:
    """The numbers of served outputs ``(wave, sr, mel)`` against the
    reference's ``refs`` of the same requests."""
    s, chunked = sampler(traffic), traffic["entry"] == "single"
    out = {"mel_rel_l2": 0.0, "wave_rel_l2": 0.0, "frames_off": 0.0}
    for (w, sr, mel), (mels_ref, rms) in zip(outs, refs):
        mel_ref = np.concatenate(mels_ref, axis=1)
        off = abs(mel.shape[1] - mel_ref.shape[1])
        off += 0 if sr == model.mel["target_sample_rate"] and mel.shape[0] == mel_ref.shape[0] \
            else 1
        if not off:
            cuts = np.cumsum([m.shape[1] for m in mels_ref])[:-1]
            with exact_float32():
                w_ref = ref.vocode(model, s, np.split(mel, cuts, axis=1), rms, device, chunked)
            off += abs(len(w) - len(w_ref))
        out["frames_off"] += off
        gaps = {"mel_rel_l2": rel_l2(mel, mel_ref), "wave_rel_l2": rel_l2(w, w_ref)} \
            if not off else {"mel_rel_l2": float("inf"), "wave_rel_l2": float("inf")}
        for k, v in gaps.items():
            out[k] = max(out[k], v)
    return out


def compare(picks: list, pool: List[gen.Request], model: ref.Model, traffic: dict,
            device) -> Dict[str, float]:
    """The numbers of one sample of served requests against the reference."""
    refs = reference([pool[rec.index] for rec in picks], model, traffic, device)
    return numbers([rec.out for rec in picks], refs, model, traffic, device)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number the cell's limits
    name at or under its limit; a limit without a number fails."""
    checks = {k: {"value": numbers.get(k), "limit": limits[k]} for k in sorted(limits)}
    ok = all(c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
