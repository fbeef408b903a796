"""The frozen yardsticks: the FLOP count against the port's own today, and
the kernel bounds against PERF.md's table."""

import json

import pytest

from portbench import flops, roofline
from portbench.spec import Bench
from portbench.tests.tiny import REPO

DIT = Bench(REPO).family("backbone", "DiT")


def _config(config):
    return json.loads((REPO / f"portbench/configs/{config}.json").read_text())


def _sampler(mix):
    return json.loads((REPO / f"portbench/traffic/{mix}.json").read_text())["sampler"]


@pytest.mark.parametrize("config,mix", [("multilingual", "serve-c8-bf16"),
                                        ("f5tts_base", "single")])
@pytest.mark.parametrize("batch,n", [(1, 1024), (2, 1536), (4, 1024), (4, 1536)])
def test_flops_equal_the_ports_count(config, mix, batch, n):
    from lemas_tts_tpu_torch.cfm.sampler import SamplerSettings, block_cache_fields
    from lemas_tts_tpu_torch.config import load_model_config
    from lemas_tts_tpu_torch.utils.flops import sampler_call_flops

    arch = load_model_config(REPO / f"portbench/configs/{config}.json").arch
    s = _sampler(mix)
    settings = SamplerSettings(steps=s["nfe_steps"], cfg_strength=s["cfg_strength"],
                               sway_sampling_coef=s["sway_sampling_coef"],
                               cfg_cutoff=s["cfg_cutoff"],
                               **block_cache_fields(s["block_cache"], arch.depth))
    want = sampler_call_flops(arch, settings, batch, n, 100)
    got = DIT.sampler_call_flops(_config(config), s, batch, n)
    assert got["bf16"] + got["int8"] == pytest.approx(want, rel=1e-12)
    q = DIT.sampler_call_flops(_config(config), s, batch, n, quant="int8")
    assert q["bf16"] + q["int8"] == pytest.approx(want, rel=1e-12) and q["int8"] > q["bf16"]


FLAGSHIP = {"dim": 1024, "heads": 16, "dim_head": 64, "ff_mult": 2}


@pytest.mark.parametrize("kernel,valid,ms", [("K1", 2048, 0.0130), ("K2", 2048, 0.0174),
                                             ("K3", 1024 + 859, 0.0080),
                                             ("K5", 1024 - 37 + 1024, 0.0085)])
def test_bounds_match_perf_table(kernel, valid, ms):
    """PERF.md §6 at rows 2, N 1024, 16 x 64, bf16 (K3's rows valid 1024 and
    859 keys, K5's 987 and 1024, as chip_smoke.py masks them)."""
    got = roofline.call_bound(kernel, FLAGSHIP, 2, 1024, valid) * 1e3
    assert round(got, 4) == ms


@pytest.mark.parametrize("name,kernel", [
    ("void sm90::ln_mod_kernel(bf16 const*, bf16 const*)", "K1"),
    ("void sm90::gemm_sm90_kernel<192, 4, false, 0>(sm90::GemmMaps, sm90::GemmArgs)", "K1"),
    ("void sm90::ln_stats_kernel(bf16 const*, float2*, int, int)", "K2"),
    ("void sm90::gemm_sm90_kernel<128, 4, true, 1>(sm90::GemmMaps, sm90::GemmArgs)", "K2"),
    ("void sm90::gemm_sm90_kernel<128, 4, false, 2>(sm90::GemmMaps, sm90::GemmArgs)", "K2"),
    ("void (anonymous namespace)::attn_nhd_sm90_kernel<64, false>(CUtensorMap)", "K3"),
    ("void (anonymous namespace)::attn_nhd_sm90_kernel<64, true>(CUtensorMap)", "K4"),
    ("void (anonymous namespace)::attn_bhnd_sm90_kernel<64, 2, 1>(CUtensorMap)", "K5"),
    ("ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_stages_64x4_tn", None),
])
def test_kernel_symbols(name, kernel):
    assert roofline.kernel_of(name) == kernel


def test_routing_per_config():
    assert DIT.block_kernels(_config("multilingual"), None) == ["K1", "K3", "K2"]
    assert DIT.block_kernels(_config("multilingual"), "int8") == ["K3"]
    assert DIT.block_kernels(_config("f5tts_base"), None) == ["K5", "K2"]


def test_launches_per_batch_of_the_served_schedule():
    """396 block evaluations a sampler call at the serving defaults, 704
    at the library's: PERF.md §6's counts."""
    assert sum(b for _, b in flops.schedule(_sampler("serve-c8-bf16"), 22)) == 396
    assert sum(b for _, b in flops.schedule(_sampler("single"), 22)) == 704
    calls = roofline.batch_bounds(DIT, _config("multilingual"), _sampler("serve-c8-bf16"), None,
                                  1024, [900] * 4)
    assert {k: v[0] for k, v in calls.items()} == {"K1": 396, "K2": 396, "K3": 396}
