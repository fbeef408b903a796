"""One request end to end, as the two entry points define it: the serving
engine's ``synthesize_requests`` row (one text) and ``synthesize_chunks``
(a request's text chunks as one batch that shares the seeded noise).

1. Reference prep: RMS normalisation up to ``target_rms``, resampling to the
   model rate, the log-mel of the reference (its frames are the kept frames).
2. Text ids (UTF-8 bytes of the reference text and the chunk) and the
   duration estimate: the reference's frames per text unit extrapolated to
   the new text (speed 0.3 for a chunk under 10 bytes), at least the text
   and the reference plus one, at most 4096; the bucket is the smallest
   duration bucket that holds the batch's longest duration.
3. Noise: ``torch.randn([N, n_mels])`` from a generator on the device seeded
   with the request's seed.
4. The Euler ODE over the sway-warped grid ``linspace(0, 1)^(1 + coef)``
   with classifier-free guidance ``v + (v - v_uncond) * cfg * (1 - t)^2``
   clamped to +-20, the guidance dropped once ``cfg (1 - t)^2 < cutoff`` (the
   clamp kept), and the block-range cache: on a refresh step the range's
   residual is stored, on the other steps it is added; the cache refreshes
   where the batch width halves. Kept frames are pasted back.
5. The generated frames (from the last reference frame on) through the vocoder,
   the RMS restored, the wave clipped to +-0.999; chunks are cross-faded.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import audio

DURATION_BUCKETS = (256, 512, 768, 1024, 1536, 2048, 3072, 4096)
MAX_FRAMES = 4096


def bucket(n: int) -> int:
    return next((b for b in DURATION_BUCKETS if n <= b), DURATION_BUCKETS[-1])


def time_grid(steps: int, sway: Optional[float]) -> np.ndarray:
    """The sway-warped grid, the coefficient capped where ``dt^(1 + coef)``
    would fall under 1e-9 (with a 0.7 safety factor) and floored at -1."""
    dt = 1.0 / max(1, steps)
    p_max = 11.0 if dt >= 0.9 else math.log(1e-9) / math.log(dt)
    cap = max(0.0, p_max - 1.0) * 0.7
    coef = max(cap if sway is None else min(cap, float(sway)), -1.0)
    return (np.linspace(0.0, 1.0, steps + 1) ** (1.0 + coef)).astype(np.float32)


def refresh_flags(steps: int, spec: Optional[str]):
    """(lo, hi) and the refresh flags of a block-cache spec
    ``lo-hi:every[+hN][+tN]``, or None."""
    if not spec:
        return None
    rng, _, rest = spec.partition(":")
    lo, hi = (int(v) for v in rng.split("-"))
    parts = rest.split("+")
    every = int(parts[0] or 2)
    flags = np.arange(steps) % every == 0
    for p in parts[1:]:
        if p[0] == "h":
            flags[: int(p[1:])] = True
        elif p[0] == "t":
            flags[max(0, steps - int(p[1:])):] = True
    return (lo, hi), flags


@dataclass
class Sampler:
    nfe_steps: int = 32
    cfg_strength: float = 3.0
    sway_sampling_coef: Optional[float] = 1.0
    cfg_cutoff: Optional[float] = None
    block_cache: Optional[str] = None
    target_rms: float = 0.1
    cross_fade_duration: float = 0.15
    speed: float = 1.0


@dataclass
class Model:
    """What the reference needs of a configuration: the configuration, the
    reference halves of its backbone and vocoder families (the modules that
    ``portbench/spec.py`` finds by name: ``text_embedding``, ``velocity``,
    ``decode`` and the quantization hooks), and their float32 weights
    (``quant``: 8 or 4, the backbone's block products in int8 or int4, its
    ``quantize_blocks``; ``"fp8"``, every product of the backbone and the
    vocoder's linear layers in float8 e4m3, their ``quantize_all``; None,
    float32 throughout)."""

    config: dict
    backbone: ModuleType
    vocoder: ModuleType
    backbone_w: Dict[str, torch.Tensor]
    vocoder_w: Dict[str, torch.Tensor]
    quant: Optional[object] = None

    def __post_init__(self):
        if self.quant == "fp8":
            self.backbone_w = _hook(self.backbone, "quantize_all")(self.backbone_w, self.config,
                                                                   "fp8")
            self.vocoder_w = _hook(self.vocoder, "quantize_all")(self.vocoder_w, self.config,
                                                                 "fp8")
        elif self.quant:
            self.backbone_w = _hook(self.backbone, "quantize_blocks")(self.backbone_w,
                                                                      self.config, self.quant)

    @property
    def mel(self) -> dict:
        return self.config["model"]["mel_spec"]


def _hook(family: ModuleType, name: str):
    fn = getattr(family, name, None)
    if fn is None:
        raise ValueError(f"the family {family.__name__} has no {name}: it cannot make this "
                         "control")
    return fn


def prepare(ref_wav: np.ndarray, ref_sr: int, mel: dict, target_rms: float) -> dict:
    x = np.asarray(ref_wav, np.float64)
    r = audio.rms(x)
    if 0 < r < target_rms:
        x = x * (target_rms / r)
    x = audio.resample(x, ref_sr, mel["target_sample_rate"])
    cond = audio.log_mel(x, mel["target_sample_rate"], mel["n_fft"], mel["hop_length"],
                         mel["win_length"], mel["n_mel_channels"])
    return {"rms": r, "ref_len": len(x) // mel["hop_length"], "cond": cond.astype(np.float32)}


def duration(ref_len: int, cond_frames: int, ref_text: str, gen: str, speed: float,
             chunked: bool) -> int:
    """Frames of one row; ``chunked`` (the single-stream entry) slows a
    chunk under 10 bytes to speed 0.3."""
    if chunked and len(gen.encode("utf-8")) < 10:
        speed = 0.3
    est = ref_len + int(ref_len / max(1, len(ref_text)) * len(gen) / max(speed, 1e-6))
    n_ids = len((ref_text + gen).encode("utf-8"))
    return min(max(max(n_ids, cond_frames) + 1, est), MAX_FRAMES)


@torch.no_grad()
def sample(m: Model, s: Sampler, cond: torch.Tensor, n_cond: int, ids: torch.Tensor,
           dur: int, n: int, noise: torch.Tensor) -> torch.Tensor:
    """One row: ``cond [n_cond, D]`` kept frames, ``ids [L]`` byte ids, the
    duration and bucket, ``noise [n, D]`` -> the mel ``[n, D]``."""
    dev = noise.device
    D = noise.shape[1]
    pos = torch.arange(n, device=dev)
    mask = (pos < dur)[None]
    keep = (pos < n_cond)[None, :, None]
    c = torch.zeros(1, n, D, device=dev)
    c[0, :n_cond] = cond[:n_cond]
    y = torch.where(mask[..., None], noise[None], 0.0)
    use_cfg = s.cfg_strength >= 1e-5
    bb, W = m.backbone, m.backbone_w
    te_c = bb.text_embedding(W, m.config, ids[None], n, False)
    te_u = bb.text_embedding(W, m.config, ids[None], n, True) if use_cfg else None
    grid = time_grid(s.nfe_steps, s.sway_sampling_coef)
    steps = len(grid) - 1
    k = steps if use_cfg else 0
    if use_cfg and s.cfg_cutoff is not None:
        k = int(np.sum(s.cfg_strength * np.square(1.0 - grid[:-1]) >= s.cfg_cutoff))
    plan = refresh_flags(steps, s.block_cache)
    lo_hi, flags = plan if plan is not None else (None, np.ones(steps, bool))
    flags = flags.copy()
    if use_cfg and k < steps:
        flags[k] = True  # the width halves: the cache refreshes
    g = torch.from_numpy(grid).to(dev)
    cache = None
    for i in range(steps):
        t, dt = g[i], g[i + 1] - g[i]
        if use_cfg and i < k:
            out, cache = bb.velocity(W, m.config, torch.cat([y, y]),
                                     torch.cat([c, torch.zeros_like(c)]), torch.cat([te_c, te_u]),
                                     t, torch.cat([mask, mask]), lo_hi, bool(flags[i]), cache)
            v = out[:1] + (out[:1] - out[1:]) * (s.cfg_strength * torch.square(1.0 - t))
            v = torch.clamp(v, -20.0, 20.0)
        else:
            v, cache = bb.velocity(W, m.config, y, c, te_c, t, mask, lo_hi, bool(flags[i]), cache)
            if use_cfg:
                v = torch.clamp(v, -20.0, 20.0)
        y = y + dt * v
    return torch.where(keep, c, y)[0]


@torch.no_grad()
def generate(m: Model, s: Sampler, ref_wav: np.ndarray, ref_sr: int, ref_text: str,
             chunks: List[str], seed: int, device, chunked: bool) -> tuple:
    """``([mel [n_mels, frames] of each chunk], reference RMS)`` of one
    request whose text is ``chunks``: the single-stream entry (``chunked``)
    or a serving row (one chunk)."""
    mel = m.mel
    D = mel["n_mel_channels"]
    p = prepare(ref_wav, ref_sr, mel, s.target_rms)
    n_cond = p["cond"].shape[0]
    durs = [duration(p["ref_len"], n_cond, ref_text, c, s.speed, chunked) for c in chunks]
    n = bucket(max(durs))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    noise = torch.randn((n, D), generator=gen, device=device, dtype=torch.float32)
    cond = torch.from_numpy(p["cond"]).to(device)
    mels = []
    for c, dur in zip(chunks, durs):
        ids = torch.from_numpy(np.frombuffer((ref_text + c).encode("utf-8"), np.uint8)
                               .astype(np.int64)).to(device)
        out = sample(m, s, cond, min(n_cond, n), ids, dur, n, noise)
        start = min(p["ref_len"], dur - 1)
        mels.append(out[start:dur].T.contiguous().cpu().numpy())
    return mels, p["rms"]


@torch.no_grad()
def vocode(m: Model, s: Sampler, mels: List[np.ndarray], rms: float, device,
           chunked: bool) -> np.ndarray:
    """The wave of a request's chunk mels: each through the vocoder, the RMS
    restored, the chunks cross-faded, clipped to +-0.999."""
    waves = []
    for sl in mels:
        x = torch.from_numpy(np.ascontiguousarray(sl, np.float32)).to(device)
        w = m.vocoder.decode(m.vocoder_w, m.config, x)
        waves.append(w.double().cpu().numpy())
    return finish(s, waves, rms, m.mel["target_sample_rate"], chunked)


def finish(s: Sampler, waves: List[np.ndarray], rms: float, sr: int,
           chunked: bool) -> np.ndarray:
    """Chunk waves to the request's wave: the RMS restored, the chunks
    cross-faded, clipped to +-0.999."""
    if 0 < rms < s.target_rms:
        waves = [w * (rms / s.target_rms) for w in waves]
    wave = audio.cross_fade(waves, sr, s.cross_fade_duration) if chunked else waves[0]
    return np.clip(wave, -0.999, 0.999)


def synthesize(m: Model, s: Sampler, ref_wav: np.ndarray, ref_sr: int, ref_text: str,
               chunks: List[str], seed: int, device, chunked: bool) -> tuple:
    """``(wave, sample_rate, mel [n_mels, T])`` of one request."""
    mels, rms = generate(m, s, ref_wav, ref_sr, ref_text, chunks, seed, device, chunked)
    return (vocode(m, s, mels, rms, device, chunked), m.mel["target_sample_rate"],
            np.concatenate(mels, axis=1))
