"""Conditional-flow-matching sampler (counterpart of
``lemas_tts_tpu/cfm/sampler.py``): an Euler ODE from noise to mel with
classifier-free guidance, as a Python loop over the sway-warped time grid.

- The text embeddings of both CFG branches are computed once per utterance.
- The cond and uncond passes run as one DiT forward over a doubled batch;
  the combine ``pred + (pred - null)·cfg·(1-t)²`` comes before the ±20 clamp.
- ``cfg_cutoff`` splits the loop statically: a prefix of CFG steps, then a
  tail of cond-only steps that keep the clamp. Without CFG the cond-only pass
  skips the clamp (the reference's early return).
- Kept frames are pasted back exactly at the end.

The midpoint method, the block-range residual cache and trajectories are not
ported: asking for them raises.
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


def sway_time_grid(steps: int, sway_sampling_coef: Optional[float],
                   t_start: float = 0.0) -> np.ndarray:
    """Warped time grid [steps+1] ``linspace(t_start, 1)**(1+coef)`` (f32)."""
    coef = resolve_sway_coef(steps, sway_sampling_coef, t_start=t_start)
    t = np.linspace(t_start, 1.0, steps + 1, dtype=np.float64)
    return (t ** (1.0 + coef)).astype(np.float32)


@dataclass(frozen=True)
class SamplerSettings:
    """Static sampler configuration."""

    steps: int = 32
    cfg_strength: float = 2.0
    sway_sampling_coef: Optional[float] = None
    t_start: float = 0.0
    velocity_clamp: float = 20.0
    return_trajectory: bool = False
    method: str = "euler"
    cfg_cutoff: Optional[float] = None
    block_cache_range: Optional[tuple] = None

    def __post_init__(self):
        if self.method != "euler":
            raise NotImplementedError(f"ODE method {self.method!r}: only euler is ported")
        if self.block_cache_range is not None:
            raise NotImplementedError("the block-range residual cache is not ported yet")
        if self.return_trajectory:
            raise NotImplementedError("trajectories are not ported yet")

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


def cfg_velocity_combine(pred2: torch.Tensor, B: int, t: torch.Tensor,
                         settings: SamplerSettings) -> torch.Tensor:
    """CFG combine then clamp (reference ``cfm.py:420-424`` order)."""
    pred, null_pred = pred2[:B], pred2[B:]
    cfg_t = settings.cfg_strength * torch.square(1.0 - t)
    v = pred + (pred - null_pred) * cfg_t
    return torch.clamp(v, -settings.velocity_clamp, settings.velocity_clamp)


@torch.no_grad()
def sample_mel(model, *, cond, cond_mask, text_ids, duration, y0, time_grid,
               settings: SamplerSettings, step_cond=None) -> torch.Tensor:
    """Euler CFG flow from noise to mel. cond, y0 [B, N, D] f32; cond_mask
    [B, N] bool (True = kept frame); text_ids [B, nt] (-1 padded); duration
    [B]; time_grid [steps+1] numpy. Returns [B, N, D] f32 with the kept
    frames pasted from ``cond``."""
    B, N, _ = cond.shape
    keep = cond_mask[..., None]
    step_cond = torch.where(keep, cond if step_cond is None else step_cond, 0.0)
    attn_mask = lens_to_mask(duration, N)
    y = torch.where(attn_mask[..., None], y0, 0.0).float()
    te_cond = model.embed_text(text_ids, N, drop_text=False)
    grid = torch.from_numpy(np.asarray(time_grid, np.float32)).to(cond.device)

    def velocity_cond_only(t, x, clamp):
        v = model(x, step_cond, None, t.expand(B), attn_mask, text_embed=te_cond)
        if clamp:
            v = torch.clamp(v, -settings.velocity_clamp, settings.velocity_clamp)
        return v

    if settings.use_cfg:
        te2 = torch.cat([te_cond, model.embed_text(text_ids, N, drop_text=True)], dim=0)
        cond2 = torch.cat([step_cond, torch.zeros_like(step_cond)], dim=0)
        mask2 = torch.cat([attn_mask, attn_mask], dim=0)

        def velocity(t, x):
            pred2 = model(torch.cat([x, x], dim=0), cond2, None, t.expand(2 * B), mask2,
                          text_embed=te2)
            return cfg_velocity_combine(pred2, B, t, settings)
    else:
        def velocity(t, x):
            return velocity_cond_only(t, x, clamp=False)

    steps = len(time_grid) - 1
    k = settings.cfg_active_steps(np.asarray(time_grid))
    for i in range(steps):
        t, dt = grid[i], grid[i + 1] - grid[i]
        v = velocity(t, y) if i < k or not settings.use_cfg else \
            velocity_cond_only(t, y, clamp=True)
        y = y + dt * v
    return torch.where(keep, cond, y)  # exact paste of kept frames
