"""Conditional-flow-matching sampler (counterpart of
``lemas_tts_tpu/cfm/sampler.py``): an ODE from noise to mel with
classifier-free guidance, as a Python loop over the sway-warped time grid.

- The text embeddings of both CFG branches are computed once per utterance.
- The cond and uncond passes run as one DiT forward over a doubled batch;
  the combine ``pred + (pred - null)·cfg·(1-t)²`` comes before the ±20 clamp.
- ``cfg_cutoff`` splits the loop statically: a prefix of CFG steps, then a
  tail of cond-only steps that keep the clamp. Without CFG the cond-only pass
  skips the clamp (the reference's early return).
- ``method="midpoint"`` evaluates the velocity twice a step, at ``t`` and at
  ``t + dt/2``.
- The block-range residual cache (``block_cache_range``, DiT only, euler
  only): on refresh steps blocks ``[lo, hi)`` run and their aggregate
  residual ``h_hi - h_lo`` is stored; on the other steps that range is one
  add of the stored residual. The cache is 2B rows wide in the CFG prefix and
  B rows in the cond-only tail, whose first step always refreshes.
- Kept frames are pasted back exactly at the end.
- ``prosody_text`` ``[B, T_text, 512]`` (the prosody-conditioned DiT) goes
  into every forward: both halves of the CFG pair (the uncond half keeps it),
  the cond-only tail, the cached loop's refresh and cached steps, and both
  evaluations of a midpoint step.

- ``return_trajectory`` also returns the state after every step
  ``[steps, B, N, D]`` (before the paste), on every route.

Nothing in the loop reads the device from the host, and the time grid's
device copy is made once per (grid, device), so the whole loop can be
captured as one CUDA graph (``cfm/graph.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from lemas_tts_tpu_torch.utils.masks import lens_to_mask

# Duration buckets (mel frames): bounded set of shapes, <=4096 ≈ 44 s.
DURATION_BUCKETS = (256, 512, 768, 1024, 1536, 2048, 3072, 4096)


def pick_bucket(duration: int, buckets=DURATION_BUCKETS) -> int:
    for b in buckets:
        if duration <= b:
            return b
    return buckets[-1]


def compute_sway_max(steps: int, t_start: float = 0.0, min_ratio: float = 1e-9,
                     safety_factor: float = 0.7) -> float:
    """Safe upper bound for the sway coefficient (reference ``cfm.py:343-373``)."""
    if not 0.0 <= t_start < 1.0:
        raise ValueError(f"t_start must be in [0, 1), got {t_start}")
    dt = (1.0 - t_start) / max(1, steps)
    p_max = 11.0 if dt >= 0.9 else math.log(min_ratio) / math.log(dt)
    return max(0.0, p_max - 1.0) * safety_factor


def resolve_sway_coef(steps: int, sway_sampling_coef: Optional[float],
                      t_start: float = 0.0) -> float:
    """The effective sway coefficient: clamped to ``compute_sway_max``,
    defaulting to it when None, and never below -1 (NaN region)."""
    sway_max = compute_sway_max(steps, t_start=t_start)
    coef = sway_max if sway_sampling_coef is None else min(sway_max, float(sway_sampling_coef))
    return max(coef, -1.0)


def warped_time_grid(steps: int, coef: float, t_start: float = 0.0) -> np.ndarray:
    """[steps+1] grid ``linspace(t_start, 1)**(1+coef)`` (f32) for a resolved
    coefficient (distillation nests its coarse and fine grids on one)."""
    t = np.linspace(t_start, 1.0, steps + 1, dtype=np.float64)
    return (t ** (1.0 + coef)).astype(np.float32)


def sway_time_grid(steps: int, sway_sampling_coef: Optional[float],
                   t_start: float = 0.0) -> np.ndarray:
    """Warped time grid [steps+1] with the coefficient resolved by
    ``resolve_sway_coef``."""
    coef = resolve_sway_coef(steps, sway_sampling_coef, t_start=t_start)
    return warped_time_grid(steps, coef, t_start=t_start)


@dataclass(frozen=True)
class SamplerSettings:
    """Static sampler configuration (hashable: it keys the captured graphs)."""

    steps: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: Optional[float] = None
    t_start: float = 0.0
    velocity_clamp: float = 20.0
    return_trajectory: bool = False
    method: str = "euler"  # "euler" (reference) | "midpoint"
    cfg_cutoff: Optional[float] = None
    block_cache_range: Optional[tuple] = None  # (lo, hi) block indices
    block_cache_every: int = 2  # refresh period (1: every step)
    block_cache_warm_head: int = 0  # always-refresh steps at the head
    block_cache_warm_tail: int = 0  # and at the tail

    def __post_init__(self):
        if self.method not in ("euler", "midpoint"):
            raise ValueError(f"unknown ODE method: {self.method!r}")
        if self.block_cache_range is not None:
            lo, hi = self.block_cache_range
            if not (0 <= lo < hi):
                raise ValueError(f"bad block_cache_range: {(lo, hi)}")
            if self.method != "euler":
                raise ValueError("block_cache_range requires method='euler'")
            if self.block_cache_every < 1:
                raise ValueError("block_cache_every must be >= 1")

    @property
    def use_cfg(self) -> bool:
        return self.cfg_strength >= 1e-5

    def cfg_active_steps(self, time_grid: np.ndarray) -> int:
        """Number of leading ODE steps that run the 2-pass CFG forward
        (cfg·(1-t)² decreases along t, so they are a prefix)."""
        steps = len(time_grid) - 1
        if not self.use_cfg:
            return 0
        if self.cfg_cutoff is None:
            return steps
        ts = np.asarray(time_grid)[:-1]
        return int(np.sum(self.cfg_strength * np.square(1.0 - ts) >= self.cfg_cutoff))


def parse_block_cache(spec: Optional[str]):
    """Parse a block-cache spec ``"lo-hi:every[+hN][+tN]"`` (e.g. ``"2-20:2"``,
    ``"0-22:2+t2"``) into ``((lo, hi), every, head, tail)``; ``None``, empty,
    ``"0"``, ``"none"`` or ``"off"`` give None. ``+hN``/``+tN`` are
    always-refresh windows of N steps at the trajectory's head/tail."""
    if not spec or str(spec).strip().lower() in ("0", "none", "off"):
        return None
    s = str(spec).strip()
    try:
        rng, _, rest = s.partition(":")
        lo, hi = (int(x) for x in rng.split("-"))
        parts = rest.split("+") if rest else [""]
        every = int(parts[0]) if parts[0] else 2
        head = tail = 0
        for p in parts[1:]:
            if p[:1] == "h":
                head = int(p[1:])
            elif p[:1] == "t":
                tail = int(p[1:])
            else:
                raise ValueError(p)
    except ValueError:
        raise ValueError(f"bad block_cache spec {spec!r} (want 'lo-hi:every[+hN][+tN]')")
    if not (0 <= lo < hi) or every < 1 or head < 0 or tail < 0:
        raise ValueError(f"bad block_cache spec {spec!r}")
    return (lo, hi), every, head, tail


def block_cache_fields(spec: Optional[str], depth: Optional[int] = None,
                       method: str = "euler") -> dict:
    """``SamplerSettings`` keyword arguments for a block-cache spec (empty
    when it is off). ``depth`` clamps ``hi`` to the model's block count (an
    empty range turns the cache off), and a method other than euler turns it
    off, as in the JAX package."""
    if method != "euler":
        return {}
    parsed = parse_block_cache(spec)
    if parsed is None:
        return {}
    (lo, hi), every, head, tail = parsed
    if depth is not None:
        hi = min(hi, int(depth))
        if lo >= hi:
            return {}
    out = {"block_cache_range": (lo, hi), "block_cache_every": every}
    if head:
        out["block_cache_warm_head"] = head
    if tail:
        out["block_cache_warm_tail"] = tail
    return out


def block_cache_flags(settings: SamplerSettings, steps: int) -> np.ndarray:
    """Refresh flags [steps] of the block-range cache: every
    ``block_cache_every``-th step, plus the warm head/tail windows;
    ``flags[0]`` is always True."""
    flags = np.arange(steps) % settings.block_cache_every == 0
    if settings.block_cache_warm_head:
        flags[: settings.block_cache_warm_head] = True
    if settings.block_cache_warm_tail:
        flags[max(0, steps - settings.block_cache_warm_tail):] = True
    return flags


def _segment_flags(flags: np.ndarray):
    """A refresh schedule as periodic regions ``[(period, count), ...]``:
    ``count`` repetitions of [refresh, cached × (period−1)]."""
    steps = len(flags)
    if steps == 0:
        return []
    if not flags[0]:
        raise ValueError("a block-cache schedule must start with a refresh")
    refresh_idx = np.flatnonzero(flags)
    periods = np.diff(np.append(refresh_idx, steps))
    regions: list = []
    for p in periods:
        if regions and regions[-1][0] == int(p):
            regions[-1][1] += 1
        else:
            regions.append([int(p), 1])
    return [(p, c) for p, c in regions]


def cfg_velocity_combine(pred2: torch.Tensor, B: int, t: torch.Tensor,
                         settings: SamplerSettings) -> torch.Tensor:
    """CFG combine then clamp (reference ``cfm.py:420-424`` order)."""
    pred, null_pred = pred2[:B], pred2[B:]
    cfg_t = settings.cfg_strength * torch.square(1.0 - t)
    v = pred + (pred - null_pred) * cfg_t
    return torch.clamp(v, -settings.velocity_clamp, settings.velocity_clamp)


_GRIDS: dict = {}


def device_time_grid(time_grid: np.ndarray, device) -> torch.Tensor:
    """The time grid's f32 copy on ``device``, made once per (grid, device):
    a loop under CUDA graph capture copies nothing from the host."""
    g = np.ascontiguousarray(time_grid, np.float32)
    key = (g.tobytes(), str(torch.device(device)))
    t = _GRIDS.get(key)
    if t is None:
        t = _GRIDS[key] = torch.from_numpy(g.copy()).to(device)
    return t


@torch.no_grad()
def sample_mel(model, *, cond, cond_mask, text_ids, duration, y0, time_grid,
               settings: SamplerSettings, step_cond=None, prosody_text=None,
               text_embed_pair=None, attn_mask_override=None) -> torch.Tensor:
    """CFG flow from noise to mel. cond, y0 [B, N, D] f32; cond_mask [B, N]
    bool (True = kept frame); text_ids [B, nt] (-1 padded); duration [B];
    time_grid [steps+1] numpy; prosody_text [B, T_text, 512] or None.
    Returns [B, N, D] f32 with the kept frames pasted from ``cond``, and
    with ``settings.return_trajectory`` also the states after each step
    ``[steps, B, N, D]``. ``text_embed_pair`` (cond, uncond text embeds;
    uncond None without CFG) and ``attn_mask_override`` ``[B, N]`` let a
    sequence-parallel caller (``parallel/sequence.py``) pass in, sharded,
    what it computed once on the whole sequence."""
    B, N, _ = cond.shape
    keep = cond_mask[..., None]
    step_cond = torch.where(keep, cond if step_cond is None else step_cond, 0.0)
    attn_mask = lens_to_mask(duration, N) if attn_mask_override is None else attn_mask_override
    y = torch.where(attn_mask[..., None], y0, 0.0).float()
    te_cond = (model.embed_text(text_ids, N, drop_text=False) if text_embed_pair is None
               else text_embed_pair[0])
    grid = device_time_grid(time_grid, cond.device)
    dts = grid[1:] - grid[:-1]

    cfg_pack = None
    if settings.use_cfg:
        te_uncond = (model.embed_text(text_ids, N, drop_text=True) if text_embed_pair is None
                     else text_embed_pair[1])
        if te_uncond is None:
            raise ValueError("CFG needs the uncond text embedding")
        te2 = torch.cat([te_cond, te_uncond], dim=0)
        cond2 = torch.cat([step_cond, torch.zeros_like(step_cond)], dim=0)
        mask2 = torch.cat([attn_mask, attn_mask], dim=0)
        pt2 = (None if prosody_text is None
               else torch.cat([prosody_text, prosody_text], dim=0))
        cfg_pack = (te2, cond2, mask2, pt2)

    steps = len(time_grid) - 1
    k = settings.cfg_active_steps(np.asarray(time_grid))
    traj = [] if settings.return_trajectory else None

    def finish(y):
        out = torch.where(keep, cond, y)  # exact paste of kept frames
        return (out, torch.stack(traj)) if traj is not None else out

    if settings.block_cache_range is not None:
        y = _block_cached_loop(model, settings, grid, dts, k, y, step_cond=step_cond,
                               attn_mask=attn_mask, te_cond=te_cond, prosody_text=prosody_text,
                               cfg_pack=cfg_pack, traj=traj)
        return finish(y)

    def velocity_cond_only(t, x, clamp):
        v = model(x, step_cond, None, t.expand(B), attn_mask, text_embed=te_cond,
                  prosody_text=prosody_text)
        if clamp:
            v = torch.clamp(v, -settings.velocity_clamp, settings.velocity_clamp)
        return v

    if settings.use_cfg:
        te2, cond2, mask2, pt2 = cfg_pack

        def velocity(t, x):
            pred2 = model(torch.cat([x, x], dim=0), cond2, None, t.expand(2 * B), mask2,
                          text_embed=te2, prosody_text=pt2)
            return cfg_velocity_combine(pred2, B, t, settings)
    else:
        def velocity(t, x):
            return velocity_cond_only(t, x, clamp=False)

    for i in range(steps):
        vel = velocity if i < k or not settings.use_cfg else \
            (lambda t, x: velocity_cond_only(t, x, clamp=True))
        t, dt = grid[i], dts[i]
        if settings.method == "midpoint":
            half = 0.5 * dt
            y_mid = y + half * vel(t, y)
            y = y + dt * vel(t + half, y_mid)
        else:
            y = y + dt * vel(t, y)
        if traj is not None:
            traj.append(y)
    return finish(y)


def _block_cached_loop(model, settings: SamplerSettings, grid, dts, k: int, y, *, step_cond,
                       attn_mask, te_cond, prosody_text, cfg_pack, traj=None):
    """The Euler loop under the block-range residual cache (JAX
    ``make_cached_forward`` and ``_scan_block_cached``): the refresh
    schedule's regions run as [refresh step, (period−1) cached steps]; the
    cond-only tail after a CFG prefix refreshes at its first step, since the
    batch width halves there. ``traj``, a list, takes the state after each
    step."""
    if not hasattr(model, "run_blocks"):
        raise ValueError("the block cache supports the DiT backbone only")
    lo, hi = settings.block_cache_range
    depth = len(model.transformer_blocks)
    if not (0 <= lo < hi <= depth):
        raise ValueError(f"block_cache_range {(lo, hi)} outside depth {depth}")
    B = y.shape[0]
    steps = dts.shape[0]
    clamp = settings.velocity_clamp
    flags = block_cache_flags(settings, steps)

    def fwd(x, cond_x, mask_x, te_x, pt_x, t, cache, refresh: bool):
        h0, t_emb, angles = model.embed_inputs(x, cond_x, None, t.expand(x.shape[0]),
                                               text_embed=te_x, prosody_text=pt_x)
        h = model.run_blocks(h0, t_emb, mask_x, angles, 0, lo)
        if refresh:
            h_mid = model.run_blocks(h, t_emb, mask_x, angles, lo, hi)
            h, cache = h_mid, h_mid - h
        else:
            h = h + cache
        h = model.run_blocks(h, t_emb, mask_x, angles, hi, depth)
        return model.head(h, t_emb, residual=h0), cache

    def cond_only(t, x, cache, refresh, do_clamp):
        pred, cache = fwd(x, step_cond, attn_mask, te_cond, prosody_text, t, cache, refresh)
        return (torch.clamp(pred, -clamp, clamp) if do_clamp else pred), cache

    def cfg_vel(t, x, cache, refresh):
        te2, cond2, mask2, pt2 = cfg_pack
        pred2, cache = fwd(torch.cat([x, x], dim=0), cond2, mask2, te2, pt2, t, cache,
                           refresh)
        return cfg_velocity_combine(pred2, B, t, settings), cache

    def run(vel, start: int, part_flags, y):
        cache, i = None, start
        for period, count in _segment_flags(part_flags):
            for _ in range(count):
                for j in range(period):
                    v, cache = vel(grid[i], y, cache, j == 0)
                    y = y + dts[i] * v
                    if traj is not None:
                        traj.append(y)
                    i += 1
        return y

    if settings.use_cfg and k < steps:
        tail = flags[k:].copy()
        tail[0] = True  # the batch width halves at the boundary
        y = run(cfg_vel, 0, flags[:k], y)
        return run(lambda t, x, c, r: cond_only(t, x, c, r, True), k, tail, y)
    vel = cfg_vel if settings.use_cfg else (lambda t, x, c, r: cond_only(t, x, c, r, False))
    return run(vel, 0, flags, y)
