"""The UNetT family (``backbones/unett.py``, ``reference/unett.py``) and the
cell ``e2tts_base.single-1chunk``.

- The FLOP count of one sampler call at the published widths (rows 2: one
  request under CFG), pinned and recounted term by term; the kernels one
  block runs (K5 only) and the controls (fp8, no W8A8).
- ``spec.py`` finds the cell, its family, its limits and its four readers.
- The readers on a slice laid out by hand: ``k5_launches_per_batch`` 768,
  ``e2tts_mfu``, ``k5_roofline``, ``e2tts_sampler_ms`` (None where a span
  lost K5 calls).
- A tiny UNetT cell runs end to end on the CPU and checks correct against
  the reference.
- On the card (``card``): one depth-24 request launches 768 K5 and 64 conv
  kernels; the fp8 control fails the cell's limits.
"""

import json
from types import SimpleNamespace

import pytest
import torch

from portbench import calibrate, check, roofline, spans, system
from portbench import traffic as gen
from portbench.drive import Span
from portbench.run import run_cell
from portbench.spec import Bench
from portbench.tests import tiny
from portbench.trace import Profile

CELL = "e2tts_base.single-1chunk"
K5 = "void (anonymous namespace)::attn_bhnd_sm90_kernel<64>(CUtensorMap)"
SEED = 2 ** 31 + 23


@pytest.fixture(scope="module")
def bench():
    return Bench(tiny.REPO)


@pytest.fixture(scope="module")
def cell(bench):
    return bench.cell(CELL)


def _sampler():
    return json.loads((tiny.REPO / "portbench/traffic/single-1chunk.json").read_text())["sampler"]


@pytest.mark.parametrize("n,tflop", [(1024, 50.119221182464), (1536, 80.105609101312)])
def test_sampler_call_flops_at_the_published_widths(cell, n, tflop):
    got = cell.backbone.sampler_call_flops(cell.config, _sampler(), 1, n)
    assert got["int8"] == 0.0 and got["bf16"] / 1e12 == pytest.approx(tflop, rel=1e-12)
    d, mel, n1 = 1024, 100, n + 1
    block = 8 * n1 * d * d + 4 * n1 * n1 * d + 4 * 4 * n1 * d * d  # q/k/v/out, scores/values, ff
    per_row = (24 * block + 12 * 4 * n1 * d * d  # 24 blocks, 12 skip projections 2d -> d
               + 2 * n * 300 * d + 2 * 2 * n * d * 64 * 31  # input projection, conv pos embed
               + 2 * (256 * d + d * d) + 2 * n * d * mel)  # time MLP, head
    assert got["bf16"] == pytest.approx(2 * 32 * per_row, rel=1e-12)  # rows 2, NFE 32


def test_block_kernels_and_controls(cell):
    bb = cell.backbone
    assert bb.block_kernels(cell.config, None) == ["K5"] and bb.depth(cell.config) == 24
    assert bb.quantize_blocks is None and callable(bb.quantize_all)
    got = roofline.batch_bounds(bb, cell.config, _sampler(), None, 1024, [1000])
    assert list(got) == ["K5"] and got["K5"][0] == 768  # 24 blocks x NFE 32


def test_spec_finds_the_cell(cell):
    assert cell.backbone.__name__.endswith("unett") and cell.vocoder.__name__.endswith("vocos")
    assert cell.config["model"]["arch"]["depth"] == 24 and cell.traffic_name == "single-1chunk"
    assert set(cell.limits) == {"mel_rel_l2", "wave_rel_l2", "frames_off", "failed_requests"}
    assert cell.limits["frames_off"] == 0 and cell.limits["failed_requests"] == 0
    names = [m["name"] for m in cell.per_layer]
    for m in ("e2tts_mfu", "k5_roofline", "k5_launches_per_batch", "e2tts_sampler_ms"):
        assert m in names
    assert "mfu" not in names and "sampler_ms" not in names  # the flagship's, not this cell's


def _run(bench, cell, k5_per_call=768, k5_us=50.0):
    """A traced run whose slice made two calls (1024 bucket, one row of 1000
    frames) at 1000 and 40000 us of the profiler's clock; each call's sample
    span launched ``k5_per_call`` K5 calls of ``k5_us`` back to back, and
    took 40 ms of the 50 ms slice from its first to its last operation."""
    ops, marks = [], []
    for base in (1000.0, 40000.0):
        marks += [spans.Span("synth.request", base, base + 39000.0, 1),
                  spans.Span("synth.sample", base, base + 1000.0, 1)]
        ops += [spans.Op(K5, base + 2000 + i * k5_us, base + 2000 + (i + 1) * k5_us,
                         base + 500, 1) for i in range(k5_per_call)]
    calls = [Span(10.001, 10.039, 1, 1024, [1000]), Span(10.040, 10.078, 1, 1024, [1000])]
    sl = SimpleNamespace(prof=None, spans=calls, t0=10.0, t1=10.05)
    run = SimpleNamespace(
        window=SimpleNamespace(slice=sl, spans=calls + calls, t_start=9.0, seconds=45.0,
                               launches={"vmem_attention": 4 * 768, "conv_taps_mish": 4 * 64}),
        profile=Profile(0.05, [(o.name, o.t0, o.t1 - o.t0) for o in ops]),
        config=cell.config, backbone=cell.backbone, kernel=bench.kernel,
        traffic=cell.traffic)
    run.program_trace = spans.Trace(marks, ops)
    return run


def test_readers_on_a_slice_laid_out_by_hand(bench, cell):
    read = bench.readers(cell.per_layer)
    run = _run(bench, cell)
    assert read["k5_launches_per_batch"](run) == 768
    flops = cell.backbone.sampler_call_flops(cell.config, cell.traffic["sampler"], 1, 1024)
    assert read["e2tts_mfu"](run) == pytest.approx(100 * 2 * flops["bf16"] / 989.4e12 / 0.05)
    bound = roofline.batch_bounds(cell.backbone, cell.config, cell.traffic["sampler"], None,
                                  1024, [1000])["K5"]
    per_call_us = bound[1] / bound[0] * 1e6
    assert read["k5_roofline"](run) == pytest.approx(100 * per_call_us / 50.0)
    assert read["e2tts_sampler_ms"](run) == pytest.approx(768 * 50.0 / 1e3)


def test_readers_give_none_where_the_run_holds_nothing(bench, cell):
    read = bench.readers(cell.per_layer)
    lost = _run(bench, cell, k5_per_call=700)  # more than MIN_CALLS_FOUND allows
    assert read["e2tts_sampler_ms"](lost) is None and read["k5_roofline"](lost) is None
    none = _run(bench, cell)
    none.window.launches = {"vmem_attention": 0}
    none.profile = none.program_trace = None
    for name in ("k5_launches_per_batch", "e2tts_mfu", "k5_roofline", "e2tts_sampler_ms"):
        assert read[name](none) is None, name


def _tiny_unett_root(tmp_path):
    root = tiny.make_root(tmp_path, entry="single")
    cfg = json.loads((tiny.REPO / "portbench/configs/e2tts_base.json").read_text())
    cfg.update(name="tiny", precision="float32")
    cfg["model"]["arch"].update(dim=128, depth=4, heads=2, dim_head=64)
    cfg["vocoder"] = tiny.tiny_config()["vocoder"]
    (root / "portbench/configs/tiny.json").write_text(json.dumps(cfg))
    return root


def test_tiny_unett_cell_runs_and_checks_correct(tmp_path):
    torch.set_num_threads(4)
    root = _tiny_unett_root(tmp_path)
    r = run_cell(root, tiny.CELL, SEED, 2.0, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["mel_rel_l2"]["value"] < 2e-4


@pytest.mark.card
def test_one_request_launches_768_k5_and_64_conv(cuda, cell):
    from lemas_tts_tpu_torch.ops import launches

    system.build_kernels(cuda)
    cfg_file = tiny.REPO / "portbench/configs/e2tts_base.json"
    sysm = system.build(cell, cell.traffic, cfg_file, SEED, cuda)
    pool = gen.pool(cell.traffic, SEED)
    system.warm(sysm, pool, cell.traffic)
    r = pool[0]
    before = {k: f.launches for k, f in launches.counters().items()}
    sysm.synth.synthesize_chunks(r.ref_wav, r.ref_sr, r.ref_text, r.chunks, cfg=sysm.cfg,
                                 seed=r.seed)
    torch.cuda.synchronize(cuda)
    got = {k: f.launches - before[k] for k, f in launches.counters().items()}
    assert got["vmem_attention"] == 768 and got["conv_taps_mish"] == 64, got
    assert sum(got.values()) == 768 + 64, got  # no K1-K4 or K6


@pytest.mark.card
def test_fp8_control_fails_the_limits(cuda, cell):
    system.build_kernels(cuda)
    path = tiny.REPO / "portbench/configs/e2tts_base.json"
    systems = {}
    for s in (201, 202):
        got = calibrate.readings(cell, path, systems, s, ["reference-fp8"], cuda)
        ok, checks = check.judge(dict(got["reference-fp8"], failed_requests=0.0), cell.limits)
        assert not ok, checks
