"""The sampler's serving modes against the JAX package on the CPU: the
block-range residual cache (spec grammar, settings fields, refresh flags and
their segmentation, the cached loop) and the midpoint method.

The sampler runs a DiT of width 128 (2 heads x 64), depth 2, on 20 mels; the
JAX DiT on its plain ``xla`` path, the port's through the plain versions of
its kernels, the same weights (carried over by ``weights.py``) and the same
``y0``. f32; tolerance 2e-4 of the output's peak, the repo's usual bar for a
few ODE steps of a two-block DiT summed in another order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lemas_tts_tpu.cfm import sampler as jsampler
from lemas_tts_tpu.config import DiTArch as JArch
from lemas_tts_tpu.models.dit import DiT as JDiT
from lemas_tts_tpu_torch import weights
from lemas_tts_tpu_torch.cfm import sampler
from lemas_tts_tpu_torch.config import DiTArch
from lemas_tts_tpu_torch.models.dit import DiT

ARCH = dict(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32, conv_layers=1)
SPECS = ["2-20:2", "0-22:2+t2", "2-20:3+h1+t6", "1-4", "0", None, "", "none", "OFF",
         "5-3:2", "2-20:0", "2-20:2+q1", "x", "2-20:2+t-1", "-1-4:2"]


def _same_outcome(jfn, fn, *args):
    """The port's function gives JAX's result, or raises ValueError where it
    does."""
    try:
        want = jfn(*args)
    except ValueError:
        with pytest.raises(ValueError):
            fn(*args)
        return None
    got = fn(*args)
    assert got == want
    return got


@pytest.mark.parametrize("spec", SPECS)
def test_parse_block_cache_matches_jax(spec):
    _same_outcome(jsampler.parse_block_cache, sampler.parse_block_cache, spec)


@pytest.mark.parametrize("spec", ["0-22:2+t2", "2-20:2", "3-8:4+h2", "2-4:1", "0"])
@pytest.mark.parametrize("depth", [None, 2, 3, 22])
@pytest.mark.parametrize("method", ["euler", "midpoint"])
def test_block_cache_fields_match_jax(spec, depth, method):
    _same_outcome(jsampler.block_cache_fields, sampler.block_cache_fields, spec, depth, method)


@pytest.mark.parametrize("fields", [dict(block_cache_every=2), dict(block_cache_every=3),
                                    dict(block_cache_every=2, block_cache_warm_tail=2),
                                    dict(block_cache_every=4, block_cache_warm_head=3,
                                         block_cache_warm_tail=5),
                                    dict(block_cache_every=1)])
@pytest.mark.parametrize("steps", [1, 7, 16, 32])
def test_block_cache_flags_and_segments_match_jax(fields, steps):
    kw = dict(block_cache_range=(0, 2), **fields)
    jflags = jsampler.block_cache_flags(jsampler.SamplerSettings(**kw), steps)
    flags = sampler.block_cache_flags(sampler.SamplerSettings(**kw), steps)
    np.testing.assert_array_equal(flags, jflags)
    assert sampler._segment_flags(flags) == jsampler._segment_flags(jflags)


@pytest.mark.parametrize("kw", [dict(method="rk4"), dict(block_cache_range=(3, 3)),
                                dict(block_cache_range=(-1, 2)),
                                dict(block_cache_range=(0, 2), method="midpoint"),
                                dict(block_cache_range=(0, 2), block_cache_every=0)])
def test_settings_refuse_as_jax_does(kw):
    with pytest.raises(ValueError):
        jsampler.SamplerSettings(**kw)
    with pytest.raises(ValueError):
        sampler.SamplerSettings(**kw)


def test_serving_schedule_step_counts():
    """The serving defaults (NFE 32, CFG 3, sway 1, cutoff 0.5, "0-22:2+t2"):
    25 CFG steps then 7 cond-only ones; 13 refresh steps in the CFG prefix
    and 5 in the tail, which refreshes at its first step: the same counts
    from the port's functions as from the JAX package's."""
    counts = []
    for mod in (jsampler, sampler):
        s = mod.SamplerSettings(steps=32, cfg_strength=3.0, sway_sampling_coef=1.0,
                                cfg_cutoff=0.5, **mod.block_cache_fields("0-22:2+t2", 22))
        grid = mod.sway_time_grid(32, 1.0)
        k = s.cfg_active_steps(grid)
        flags = mod.block_cache_flags(s, 32)
        tail = flags[k:].copy()
        tail[0] = True
        counts.append((k, int(flags[:k].sum()), int(tail.sum())))
    assert counts[0] == counts[1] == (25, 13, 5)


@pytest.fixture(scope="module")
def models():
    jdit = JDiT(arch=JArch(**ARCH), mel_dim=20, text_num_embeds=11)
    params = jdit.init(jax.random.key(0), jnp.zeros((1, 32, 20)), jnp.zeros((1, 32, 20)),
                       jnp.zeros((1, 8), jnp.int32), jnp.zeros((1,)))
    dit = DiT(DiTArch(**ARCH), mel_dim=20, text_num_embeds=11)
    dit.load_state_dict(weights.dit_state_from_jax(params))
    return jdit, params, dit.eval()


def _inputs(B=2, N=64, nt=16, D=20):
    rng = np.random.default_rng(0)
    cond = np.zeros((B, N, D), np.float32)
    cond[:, :20] = rng.standard_normal((B, 20, D))
    cond_mask = np.zeros((B, N), bool)
    cond_mask[:, :20] = True
    text = np.full((B, nt), -1, np.int32)
    text[0, :12] = rng.integers(0, 11, 12)
    text[1, :7] = rng.integers(0, 11, 7)
    duration = np.asarray([N, 50], np.int32)
    y0 = rng.standard_normal((B, N, D)).astype(np.float32)
    return dict(cond=cond, cond_mask=cond_mask, text_ids=text, duration=duration, y0=y0)


MODES = {
    "midpoint": dict(method="midpoint"),
    "midpoint-cutoff": dict(method="midpoint", cfg_cutoff=0.5),
    "midpoint-no-cfg": dict(method="midpoint", cfg_strength=0.0),
    "cache-serving-cutoff": dict(cfg_cutoff=0.5, spec="0-22:2+t2"),
    "cache-lo1": dict(spec="1-2:2"),
    "cache-no-cfg": dict(cfg_strength=0.0, spec="0-2:3+h1"),
    "cache-every1": dict(spec="0-2:1", cfg_cutoff=1.0),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_sampler_modes_match_jax(models, mode):
    jdit, params, dit = models
    kw = dict(MODES[mode])
    spec = kw.pop("spec", None)
    base = dict(steps=6, cfg_strength=2.0, sway_sampling_coef=1.0)
    base.update(kw)
    jset = jsampler.SamplerSettings(**base, **jsampler.block_cache_fields(spec, 2))
    tset = sampler.SamplerSettings(**base, **sampler.block_cache_fields(spec, 2))
    assert (spec is None) == (tset.block_cache_range is None)
    x = _inputs()
    want = np.asarray(jsampler.make_sampler(jdit, jset)(
        params, *(jnp.asarray(x[k]) for k in ("cond", "cond_mask", "text_ids", "duration",
                                              "y0"))))
    got = sampler.sample_mel(dit, **{k: torch.from_numpy(v) for k, v in x.items()},
                             time_grid=sampler.sway_time_grid(6, 1.0), settings=tset).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * np.abs(want).max())
    keep = x["cond_mask"]
    np.testing.assert_array_equal(got[keep], x["cond"][keep])  # exact paste


def test_block_cache_changes_the_trajectory(models):
    """Cached steps really skip work: every 3rd step refreshing gives another
    mel than every step (which is exact: the same as no cache)."""
    _, _, dit = models
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    grid = sampler.sway_time_grid(6, 1.0)
    out = {}
    for name, fields in (("exact", {}), ("every1", sampler.block_cache_fields("0-2:1", 2)),
                         ("every3", sampler.block_cache_fields("0-2:3", 2))):
        out[name] = sampler.sample_mel(dit, **x, time_grid=grid, settings=sampler.SamplerSettings(
            steps=6, cfg_strength=2.0, sway_sampling_coef=1.0, **fields)).numpy()
    np.testing.assert_allclose(out["every1"], out["exact"], rtol=1e-5, atol=1e-5)
    assert not np.allclose(out["every3"], out["exact"], rtol=1e-3, atol=1e-3)
