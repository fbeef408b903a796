"""The port's measurement tools against the JAX package on the CPU, at tiny
widths (the chip run covers the flagship).

- The probes' synthetic inputs are JAX's arrays (numpy ``default_rng(seed)``
  in the JAX helper's order), bit for bit.
- ``cutoff_probe`` and ``blockcache_probe`` on a DiT of width 64 (4 heads
  of 16), depth 2, with the JAX DiT's f32 weights carried over by
  ``weights.dit_state_from_jax``: their analytic fields (active steps,
  forward-cost and block-cost ratios) equal JAX's, and ``mel_mse``/
  ``rel_l2`` agree with JAX's ``run_probe`` on the same inputs within
  rel 2e-2 (+ 1e-12 absolute on MSE): the MSE is of a difference of two
  trajectories, 1e-4 to 1e-3 of the mel's scale, so the packages' f32
  reassociation (~1e-6 of the scale) moves it by well under 1 %; the
  identity cases of ``tests/test_cutoff_probe.py`` hold exactly.
- ``kernel_check``'s ``vmem`` against ``xla`` route, K4 against K3 in
  ``attn_pack_probe`` (bit for bit), ``widehead_probe``, ``quant_probe``,
  ``distill_probe`` (its ``fwd_ratio`` from JAX's host math) and
  ``student_stack_probe`` at tiny size; ``profile_sampler`` writing and
  summarising a CPU trace; ``latency_probe``'s closed loop and
  ``--loaded_ttfb`` on a 1.5 s window of the tiny config (a 1 s reference).
- Every new CLI raises without CUDA when ``--device`` is not given.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lemas_tts_tpu.cfm import sampler as jsampler
from lemas_tts_tpu.config import DiTArch as JArch
from lemas_tts_tpu.models.dit import DiT as JDiT
from lemas_tts_tpu.scripts import _probe_common as jcommon
from lemas_tts_tpu.scripts import blockcache_probe as jblockcache
from lemas_tts_tpu.scripts import cutoff_probe as jcutoff
from lemas_tts_tpu_torch import weights
from lemas_tts_tpu_torch.config import DiTArch
from lemas_tts_tpu_torch.models.dit import DiT
from lemas_tts_tpu_torch.scripts import (
    _probe_common,
    attn_pack_probe,
    blockcache_probe,
    cutoff_probe,
    distill_probe,
    kernel_check,
    latency_probe,
    parity_check,
    profile_sampler,
    quant_probe,
    student_stack_probe,
    widehead_probe,
)

torch.set_num_threads(1)

TINY = ["--dim", "64", "--depth", "2", "--heads", "4", "--text_dim", "32", "--conv_layers", "1",
        "--n", "128", "--batch", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """JAX's probe helper at the tiny geometry made f32 on the xla route
    (the port's plain versions are f32 too), its inputs, and the port's
    model with the same weights and the port's own inputs."""
    args = cutoff_probe.build_argparser().parse_args(TINY)
    _, _, jinputs = jcommon.probe_model_and_inputs(args)
    arch = dict(dim=64, depth=2, heads=4, dim_head=16, text_dim=32, conv_layers=1)
    jmodel = JDiT(arch=JArch(**arch), mel_dim=100, text_num_embeds=898,
                  compute_dtype=jnp.float32, attn_backend="xla")
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 8, 100)),
                                  jnp.zeros((1, 8, 100)), jnp.zeros((1, 4), jnp.int32),
                                  jnp.zeros((1,)))
    model = DiT(DiTArch(**arch), mel_dim=100, text_num_embeds=898)
    model.load_state_dict(weights.dit_state_from_jax(params))
    _, inputs = _probe_common.probe_model_and_inputs(args)
    return jmodel, params, jinputs, model.eval(), inputs


def test_probe_inputs_are_jax_arrays(carried):
    _, _, jinputs, _, inputs = carried
    for j, t in zip(jinputs, inputs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(t.numpy().dtype))


def _jax_run(monkeypatch, carried, module, argv):
    """JAX's ``run_probe`` on the carried f32 model and inputs (its CLI has
    no ``--device``)."""
    jmodel, params, jinputs, _, _ = carried
    monkeypatch.setattr(jcommon, "probe_model_and_inputs",
                        lambda a: (jmodel, params, jinputs))
    return module.run_probe(module.build_argparser().parse_args(argv[:-2]))


def _close(got, want, keys):
    for k in keys:
        assert got[k] == pytest.approx(want[k], rel=2e-2, abs=1e-12), k


def test_cutoff_probe_matches_jax(carried, monkeypatch, capsys):
    argv = ["--nfe", "6", "--cfg", "2.0", "--sway", "1.0", "--cutoffs", "1e-12,0.8"] + TINY
    want = _jax_run(monkeypatch, carried, jcutoff, argv)
    capsys.readouterr()
    got = cutoff_probe.run_probe(cutoff_probe.build_argparser().parse_args(argv),
                                 *carried[3:])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines == got and [ln["cutoff"] for ln in lines] == [1e-12, 0.8]
    for g, w in zip(got, want):
        for k in ("cutoff", "active_steps", "total_steps", "fwd_cost_ratio"):
            assert g[k] == w[k], k
    tiny, moderate = got
    # a cutoff below the smallest cfg_t is the identity: bit-identical trajectory
    assert tiny["active_steps"] == tiny["total_steps"] == 6
    assert tiny["fwd_cost_ratio"] == 1.0 and tiny["mel_mse"] == 0.0 == want[0]["mel_mse"]
    # a moderate cutoff truncates a strict suffix and changes the output
    assert 0 < moderate["active_steps"] < 6 and moderate["fwd_cost_ratio"] < 1.0
    assert moderate["mel_mse"] > 0.0 and moderate["rel_l2"] > 0.0
    _close(moderate, want[1], ("mel_mse", "rel_l2", "max_abs"))


def test_blockcache_probe_matches_jax(carried, monkeypatch, capsys):
    argv = ["--nfe", "6", "--cfg", "2.0", "--sway", "1.0", "--cfg_cutoff", "0.8",
            "--specs", "0-2:2,1-2:3+t1,5-9:2", "--no_time", "--pick_mse", "1.0"] + TINY
    want = _jax_run(monkeypatch, carried, jblockcache, argv)
    capsys.readouterr()
    got = blockcache_probe.run_probe(blockcache_probe.build_argparser().parse_args(argv),
                                     *carried[3:])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines[2] == {"spec": "5-9:2", "disabled": True}  # clamped away at depth 2
    assert lines[-1]["picked"] == "0-2:2"  # the lowest block cost within the budget
    assert [g["spec"] for g in got] == [w["spec"] for w in want] == ["0-2:2", "1-2:3+t1"]
    for g, w in zip(got, want):
        assert g["block_cost_ratio"] == w["block_cost_ratio"]
        assert g["mel_mse"] > 0
        _close(g, w, ("mel_mse", "rel_l2", "mcd_db"))


def test_kernel_check_vmem_against_xla_on_cpu():
    arch = DiTArch(dim=128, depth=2, heads=2, dim_head=64, text_dim=32, conv_layers=1)
    recs = kernel_check.check_kernels([128], [1, 2], dtype=torch.float32, device="cpu",
                                      arch=arch, verbose=False)
    assert [(r["n"], r["batch"]) for r in recs] == [(128, 1), (128, 2)]
    assert all(r["ok"] and r["rel_l2"] < 1e-4 for r in recs)


def test_attn_pack_and_widehead_probes(capsys):
    recs = attn_pack_probe.run(attn_pack_probe.build_argparser().parse_args(
        ["--shapes", "1x128", "2x2560", "--heads", "2", "--reps", "1", "--device", "cpu"]))
    assert all(r["bit_equal"] and r["rel_l2"] == 0.0 for r in recs)
    args = widehead_probe.build_argparser().parse_args(
        ["--shapes", "1x128", "--dim", "256", "--depth", "1", "--n", "128", "--batch", "1",
         "--nfe", "2", "--reps", "1", "--reps_e2e", "1", "--device", "cpu"])
    assert [r["shape"] for r in widehead_probe.standalone(args)] == ["1x128"]
    rec = widehead_probe.e2e(args)
    assert rec["e2e_speedup_d128_vs_d64"] > 0
    out = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert [o.get("geometry") for o in out[-3:-1]] == ["h4d64", "h2d128"]


def test_quant_probe_tiny():
    args = quant_probe.build_argparser().parse_args(
        ["--dim", "128", "--depth", "2", "--heads", "2", "--dim_head", "64", "--n", "128",
         "--nfe", "3", "--text_dim", "32", "--conv_layers", "1", "--device", "cpu"])
    recs = quant_probe.run(args)
    assert [(r["geometry"], r["mode"]) for r in recs] == [("h2d64", "exact"),
                                                          ("h2d64", "serving")]
    # W8A8 per-token / per-channel rounding: small but nonzero divergence
    assert all(0 < r["rel_l2"] < 1e-2 for r in recs)


def test_distill_probe_tiny():
    args = distill_probe.build_argparser().parse_args(
        ["--dim", "128", "--depth", "2", "--heads", "2", "--n", "128", "--batch", "1",
         "--teacher_nfe", "4", "--stages", "2,1", "--steps", "2", "--batch_frames", "600",
         "--synthetic", "8", "--reps", "1", "--student_heads", "1",
         "--student_dim_head", "128", "--device", "cpu"])
    recs = distill_probe.run(args)
    s = jsampler.SamplerSettings(steps=4, cfg_strength=2.0, sway_sampling_coef=1.0)
    k = s.cfg_active_steps(jsampler.sway_time_grid(4, 1.0))
    assert [r["stage"] for r in recs] == [2, 1]
    for r in recs:
        assert r["fwd_ratio"] == round((2 * k + (4 - k)) / r["stage"], 2)
        assert r["steps"] == 2 and np.isfinite([r["mse_init"], r["mse_trained"],
                                                r["loss_first"], r["loss_last"]]).all()


def test_student_stack_probe_tiny(capsys):
    args = student_stack_probe.build_argparser().parse_args(
        ["--steps", "4", "--dim", "128", "--depth", "2", "--heads", "1", "--dim_head", "128",
         "--n", "128", "--batch", "1", "--specs", "0-2:2,0-22:2+t2", "--no_time",
         "--pick_mse", "1.0", "--text_dim", "32", "--conv_layers", "1", "--device", "cpu"])
    recs = student_stack_probe.run(args)
    assert [(r["spec"], r["student_nfe"]) for r in recs] == [("0-2:2", 4), ("0-22:2+t2", 4)]
    picked = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert picked == {"student_nfe": 4, "picked": "0-2:2", "pick_mse": 1.0}


def test_profile_sampler_cpu_trace(tmp_path, capsys):
    argv = ["--device", "cpu", "--batch", "1", "--nfe", "2", "--frames", "128",
            "--text_len", "32", "--top", "5", "--logdir", str(tmp_path)]
    arch = DiTArch(dim=64, depth=1, heads=4, dim_head=16)
    assert profile_sampler.main(argv, arch) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert rec["device"] == "cpu" and rec["trace"] == str(tmp_path / "sampler.json")
    assert "mfu" not in rec and rec["tflop"] > 0
    assert out[0].startswith("== cpu_op:")
    assert profile_sampler.main(["--summarize", rec["trace"], "--top", "2"]) == 0
    assert capsys.readouterr().out.startswith("== cpu_op:")


@pytest.fixture(scope="module")
def tiny_tts(tmp_path_factory):
    from lemas_tts_tpu_torch import TTS

    d = tmp_path_factory.mktemp("latency")
    (d / "vocab.txt").write_text("\n".join([" "] + list("abcdefghijklmnopqrstuvwxyz,.!'"))
                                 + "\n")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return TTS(model="tests/data/tiny.yaml", vocab_file=str(d / "vocab.txt"), frontend=None,
                   device="cpu")


def test_latency_probe_closed_and_loaded(tiny_tts, capsys, monkeypatch):
    monkeypatch.setattr(latency_probe, "REF_SECONDS", 1.0)  # shorter buckets on the CPU
    base = ["--device", "cpu", "--nfe", "1", "--max_batch", "2"]
    rec = latency_probe.run(latency_probe.build_parser().parse_args(
        base + ["--requests", "3"]), tiny_tts)["latency_probe"]
    assert rec["mode"] == "closed" and rec["shed"] == 0 and rec["latency"]["count"] == 3
    assert rec["audio_s"] > 0
    rec = latency_probe.run(latency_probe.build_parser().parse_args(
        base + ["--loaded_ttfb", "--qps", "2", "--secs", "1.5", "--loaded_streams", "1",
                "--first_chunk_chars", "20"]), tiny_tts)["latency_probe"]
    assert rec["mode"] == "loaded_ttfb" and rec["shed"] == 0
    assert rec["stream_ttfb"]["count"] >= 1 and rec["batched"]["count"] == rec["fired"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["latency_probe"] == rec and last["device"] == "cpu"


def test_warm_buckets_cover_the_mix(tiny_tts):
    """Every (duration, text) bucket of the request mix, at every batch bucket
    up to the one ``max_batch`` pads into (a max_batch of 3 pads to 4)."""
    synth = tiny_tts.synth
    sr = tiny_tts.target_sample_rate
    ref = np.zeros(sr, np.float32)
    ref[::7] = 0.1
    units = [tiny_tts.prepare_units(t) for t in latency_probe.TEXTS[-2:]]
    from lemas_tts_tpu_torch.config import SamplerConfig

    seen = []
    real = synth.run_sampler

    def spy(settings, cond, cond_mask, text_ids, *a, **k):
        seen.append((cond.shape[1], text_ids.shape[1], cond.shape[0]))
        return real(settings, cond, cond_mask, text_ids, *a, **k)

    synth.run_sampler = spy
    try:
        warmed = latency_probe.warm_buckets(synth, ref, sr, "ref text.", units,
                                            SamplerConfig(nfe_steps=1), max_batch=3)
    finally:
        del synth.run_sampler
    assert sorted(seen) == sorted(warmed)
    assert {w[2] for w in warmed} == {1, 2, 4}


CLIS = {
    "kernel_check": (kernel_check.main, ["--ns", "128", "--bs", "1"]),
    "profile_sampler": (profile_sampler.main, ["--batch", "1", "--nfe", "1"]),
    "cutoff_probe": (cutoff_probe.main, ["--nfe", "2"]),
    "blockcache_probe": (blockcache_probe.main, ["--nfe", "2"]),
    "quant_probe": (quant_probe.main, ["--nfe", "2"]),
    "attn_pack_probe": (attn_pack_probe.main, ["--shapes", "1x128"]),
    "widehead_probe": (widehead_probe.main, ["--shapes", "1x128"]),
    "latency_probe": (latency_probe.main, ["--requests", "1"]),
    "distill_probe": (distill_probe.main, ["--steps", "1"]),
    "student_stack_probe": (student_stack_probe.main, ["--steps", "2"]),
    "parity_check": (parity_check.main, None),
}


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_without_cuda_raises(name, tmp_path):
    """Without ``--device`` a CLI means CUDA, and raises here before any
    work; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is real")
    main, argv = CLIS[name]
    if argv is None:  # compare mode reads its bundle's manifest first
        (tmp_path / "captured.json").write_text(json.dumps({"cases": [{"name": "c"}]}))
        argv = ["--bundle", str(tmp_path)]
    with pytest.raises(RuntimeError, match="needs CUDA"):
        main(argv)


@pytest.mark.parametrize("name", ["cutoff_probe", "blockcache_probe", "distill_probe",
                                  "student_stack_probe", "latency_probe"])
def test_clis_keep_the_jax_flags(name):
    """The probes keep the JAX CLIs' flags and defaults; ``--device`` (None:
    CUDA) is the one flag added."""
    import importlib

    port = importlib.import_module(f"lemas_tts_tpu_torch.scripts.{name}")
    jmod = importlib.import_module(f"lemas_tts_tpu.scripts.{name}")
    parser = "build_parser" if name == "latency_probe" else "build_argparser"
    got = vars(getattr(port, parser)().parse_args([]))
    want = vars(getattr(jmod, parser)().parse_args([]))
    assert got.pop("device") is None
    assert got == want
