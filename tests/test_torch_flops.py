"""The port's FLOP model, misc utilities and card-timing helpers against the
JAX package on the CPU: ``utils/flops.py`` gives JAX's numbers (rel 1e-12:
the same float64 host arithmetic) over a grid of sampler settings, the
flagship's library defaults give 30.91 TFLOP a call, the peak is None
without a card; ``utils/misc.py`` and ``utils/profiling.py``'s interval
union and trace summary."""

import json

import numpy as np
import pytest
import torch

from lemas_tts_tpu.cfm import sampler as jsampler
from lemas_tts_tpu.config import DiTArch as JArch
from lemas_tts_tpu.utils import flops as jflops
from lemas_tts_tpu.utils.misc import repetition_found as jrepetition_found
from lemas_tts_tpu_torch.cfm import sampler
from lemas_tts_tpu_torch.config import DiTArch
from lemas_tts_tpu_torch.utils import flops, misc, profiling

torch.set_num_threads(1)

SETTINGS = {
    "defaults": dict(),
    "no-cfg": dict(cfg_strength=0.0),
    "cutoff": dict(cfg_strength=2.0, sway_sampling_coef=1.0, cfg_cutoff=0.5),
    "cutoff-nfe64-sway3": dict(steps=64, cfg_strength=5.0, sway_sampling_coef=3.0,
                               cfg_cutoff=1.0),
    "cache": dict(spec="2-20:2"),
    # the tail after the cutoff refreshes at its first step (the forced refresh)
    "cache-cutoff-serving": dict(steps=32, cfg_strength=3.0, sway_sampling_coef=1.0,
                                 cfg_cutoff=0.5, spec="0-22:2+t2"),
    "cache-warm-no-cfg": dict(steps=8, cfg_strength=0.0, spec="0-22:4+h2+t1"),
    "midpoint": dict(steps=16, method="midpoint"),
    "midpoint-cutoff": dict(steps=16, method="midpoint", cfg_cutoff=1.0),
}
ARCHES = {"flagship": {}, "wide-head": dict(heads=8, dim_head=128),
          "small": dict(dim=256, depth=4, heads=4, dim_head=64, ff_mult=2, text_dim=64,
                        conv_layers=2)}


@pytest.mark.parametrize("arch", list(ARCHES))
@pytest.mark.parametrize("name", list(SETTINGS))
@pytest.mark.parametrize("batch,n", [(1, 1024), (8, 1024), (8, 2048)])
def test_sampler_call_flops_match_jax(arch, name, batch, n):
    kw = dict(SETTINGS[name])
    spec = kw.pop("spec", None)
    depth = DiTArch(**ARCHES[arch]).depth
    jset = jsampler.SamplerSettings(**kw, **jsampler.block_cache_fields(spec, depth))
    tset = sampler.SamplerSettings(**kw, **sampler.block_cache_fields(spec, depth))
    want = jflops.sampler_call_flops(JArch(**ARCHES[arch]), jset, batch, n)
    got = flops.sampler_call_flops(DiTArch(**ARCHES[arch]), tset, batch, n)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_per_row_flops_match_jax(n):
    for name in ("dit_block_flops_per_row",):
        assert getattr(flops, name)(DiTArch(), n) == getattr(jflops, name)(JArch(), n)
    for name in ("dit_embed_head_flops_per_row", "text_embed_flops_per_row"):
        assert getattr(flops, name)(DiTArch(), n, 100) == getattr(jflops, name)(JArch(), n, 100)


def test_flagship_library_defaults_flops():
    """NFE 32, CFG 2, B 1, N 1024: 30.91 TFLOP a sampler call, as JAX's."""
    got = flops.sampler_call_flops(DiTArch(), sampler.SamplerSettings(), 1, 1024)
    assert round(got / 1e12, 2) == 30.91
    assert got == jflops.sampler_call_flops(JArch(), jsampler.SamplerSettings(), 1, 1024)


def test_device_peak_flops(monkeypatch):
    monkeypatch.delenv("LEMAS_BENCH_PEAK_TFLOPS", raising=False)
    assert flops.device_peak_flops("cpu") is None
    if not torch.cuda.is_available():
        assert flops.device_peak_flops() is None
    monkeypatch.setenv("LEMAS_BENCH_PEAK_TFLOPS", "989.4")
    assert flops.device_peak_flops() == pytest.approx(989.4e12)
    assert flops.device_peak_flops("cpu") == pytest.approx(989.4e12)


@pytest.mark.parametrize("text,length,tolerance", [
    ("ababababababababababababab", 2, 10), ("the quick brown fox", 2, 10),
    ("aaaaaaaaaaaa", 1, 10), ("aaaaaaaaaaa", 1, 10), ("", 2, 0), ("abcabcabc", 3, 2)])
def test_repetition_found_matches_jax(text, length, tolerance):
    assert misc.repetition_found(text, length, tolerance) == jrepetition_found(
        text, length, tolerance)


def test_seed_everything_and_fast_random_params():
    g = misc.seed_everything(42)
    assert isinstance(g, torch.Generator)
    a = torch.rand(3)
    misc.seed_everything(42)
    assert torch.equal(a, torch.rand(3))  # the global torch RNG is seeded too
    assert np.random.rand() == np.random.RandomState(42).rand()

    def filled(seed, dtype=None):
        m = torch.nn.Sequential(torch.nn.Linear(64, 32), torch.nn.LayerNorm(32))
        return misc.fast_random_params(m, torch.Generator().manual_seed(seed), dtype=dtype)

    m1, m2, m3 = filled(1), filled(1), filled(2)
    for p1, p2, p3 in zip(m1.parameters(), m2.parameters(), m3.parameters()):
        assert torch.equal(p1, p2) and not torch.equal(p1, p3)
    w = torch.cat([p.detach().flatten() for p in m1.parameters()])
    assert abs(float(w.std()) - 0.02) < 0.003 and abs(float(w.mean())) < 0.003
    assert all(p.dtype == torch.bfloat16 for p in filled(1, torch.bfloat16).parameters())


def test_interval_union():
    assert profiling.interval_union([]) == 0.0
    assert profiling.interval_union([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20.0
    assert profiling.interval_union([(3, 4), (0, 1)]) == 2.0


def test_summarize_trace_reads_a_cpu_trace(tmp_path):
    """A Chrome trace that torch.profiler wrote on the CPU: its host
    operators tabulated by total time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    text = profiling.summarize_trace(str(path), top=3)
    assert text.startswith("== cpu_op:") and "aten::" in text
    assert len(text.splitlines()) <= 4


def test_summarize_trace_kernel_union(tmp_path):
    """A card trace's kernels: summed time and busy time (their union)."""
    events = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 0.0, "dur": 1000.0},
              {"ph": "X", "cat": "kernel", "name": "k2", "ts": 500.0, "dur": 1000.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 9.0}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    text = profiling.summarize_trace(str(path))
    assert "summed 2.000 ms" in text and "card busy 1.500 ms" in text
    assert "aten::mm" not in text
