"""Progressive distillation of the port against the JAX package on the CPU,
and the train -> distill -> TTS -> serve -> evaluate chain through the CLIs.

- ``Distiller``: its nested coarse and fine grids equal JAX's; its loss and
  the student's gradients equal JAX ``Distiller._loss`` on the same weights,
  batch and draws, for a CFG teacher, a baked teacher of a later stage
  (strength 0) and a wide-head student (2 x 32 heads of a 4 x 16 teacher);
  the teacher gets no gradient.
- ``sample_mel(return_trajectory=True)`` equals JAX ``sample_mel``'s
  (out, trajectory) on the CFG prefix and cond-only tail, the block-range
  cache and midpoint.
- The CLIs: ``train`` (then ``--resume``, which carries on the step count)
  -> ``distill`` (stages 4,2 and a wide-head stage) -> ``TTS`` on a stage
  directory (the sampler pinned to steps=K, cfg 0, the sidecar's head
  split) -> ``serve_http`` (``/config`` reports the student) ->
  ``evaluate`` with a speaker encoder file: finite metrics.

Widths: two DiT blocks of width 64, 12 mel channels (20 in the chain), f32,
``arch.dropout = 0``. Tolerances: values rtol 2e-4, gradients per tensor
rel-L2 <= 2e-4, sampler outputs rtol 2e-4 of their peak.
"""

import json
import threading
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lemas_tts_tpu.cfm import distill as jdistill
from lemas_tts_tpu.cfm import sampler as jsampler
from lemas_tts_tpu.config import DiTArch as JArch
from lemas_tts_tpu.models.dit import DiT as JDiT
from lemas_tts_tpu_torch import weights
from lemas_tts_tpu_torch.cfm import sampler
from lemas_tts_tpu_torch.cfm.distill import Distiller, student_sampler_settings
from lemas_tts_tpu_torch.config import DiTArch
from lemas_tts_tpu_torch.models.dit import DiT

ARCH = dict(dim=64, depth=2, heads=4, dim_head=16, ff_mult=2, text_dim=32, conv_layers=1,
            dropout=0.0)
WIDE = dict(ARCH, heads=2, dim_head=32)
D, V, B, T, NT = 12, 30, 3, 64, 8
TINY = "tests/data/tiny.yaml"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def jmodel():
    jd = JDiT(arch=JArch(**ARCH), mel_dim=D, text_num_embeds=V)
    z = jnp.zeros((1, 16, D))
    params = jax.jit(lambda k: jd.init(k, z, z, jnp.zeros((1, 4), jnp.int32),
                                       jnp.zeros((1,))))(jax.random.key(0))
    return jd, params


def _batch():
    rng = np.random.default_rng(0)
    text = rng.integers(0, V, (B, NT)).astype(np.int32)
    text[2, 4:] = -1
    return {"mel": rng.standard_normal((B, T, D)).astype(np.float32),
            "mel_lengths": np.array([64, 50, 37], np.int32), "text": text}


@pytest.mark.parametrize("k,substeps,coef", [(8, 2, 1.0), (4, 3, None), (16, 2, 3.0)])
def test_grids_nest_and_match_jax(k, substeps, coef, jmodel):
    d = Distiller(DiT(DiTArch(**ARCH), mel_dim=D, text_num_embeds=V), k, substeps=substeps,
                  sway_sampling_coef=coef)
    jd = jdistill.Distiller(jmodel[0], k, substeps=substeps, sway_sampling_coef=coef)
    np.testing.assert_array_equal(d.coarse_grid, jd.coarse_grid)
    np.testing.assert_array_equal(d.fine_grid, jd.fine_grid)
    np.testing.assert_array_equal(d.fine_grid[::substeps], d.coarse_grid)
    np.testing.assert_array_equal(d.coarse_grid, sampler.sway_time_grid(k, coef))


def test_student_settings_and_next_stage():
    s = student_sampler_settings(8, sway_sampling_coef=1.0)
    assert (s.steps, s.use_cfg, s.sway_sampling_coef) == (8, False, 1.0)
    student = DiT(DiTArch(**WIDE), mel_dim=D, text_num_embeds=V)
    d = Distiller(DiT(DiTArch(**ARCH), mel_dim=D, text_num_embeds=V), 8, student_model=student)
    nxt = d.next_stage()
    assert nxt.student_steps == 4 and nxt.teacher_cfg_strength == 0.0
    assert nxt.dit_model is student and nxt.student_model is student
    bad = DiT(DiTArch(**dict(ARCH, heads=2)), mel_dim=D, text_num_embeds=V)
    with pytest.raises(ValueError, match="parameter tree"):
        Distiller(d.dit_model, 4, student_model=bad).init_state(d.dit_model.state_dict())


@pytest.mark.parametrize("case", ["cfg_teacher", "baked_teacher", "wide_head_student"])
def test_distill_loss_matches_jax(case, jmodel):
    """The distillation loss and the student's gradients against JAX
    ``Distiller._loss``: the teacher's 2 CFG sub-steps on the fine grid
    (no gradient), the student's single pass at the interval start, the
    loss over the generated span."""
    jd, tparams = jmodel
    K, strength = 4, (0.0 if case == "baked_teacher" else 2.0)
    wide = case == "wide_head_student"
    jstudent = JDiT(arch=JArch(**WIDE), mel_dim=D, text_num_embeds=V) if wide else None
    jdist = jdistill.Distiller(jd, K, teacher_cfg_strength=strength, sway_sampling_coef=1.0,
                               student_model=jstudent)
    noise = jax.tree_util.tree_map(
        lambda p: 0.02 * jax.random.normal(jax.random.key(3), p.shape), tparams)
    sparams = jax.tree_util.tree_map(lambda a, b: a + b, tparams, noise)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(11)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda sp: jdist._loss(sp, tparams, jb, key), has_aux=True))(sparams)

    r_noise, r_frac, r_span, r_seg = jax.random.split(key, 4)
    draws = {"frac": jax.random.uniform(r_frac, (B,), minval=0.7, maxval=1.0),
             "span": jax.random.uniform(r_span, (B,)),
             "seg": jax.random.randint(r_seg, (B,), 0, K),
             "x0": jax.random.normal(r_noise, (B, T, D))}
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    teacher = DiT(DiTArch(**ARCH), mel_dim=D, text_num_embeds=V)
    student = DiT(DiTArch(**WIDE), mel_dim=D, text_num_embeds=V) if wide else None
    dist = Distiller(teacher, K, teacher_cfg_strength=strength, sway_sampling_coef=1.0,
                     student_model=student)
    state = dist.init_state(weights.dit_state_from_jax(tparams))
    state.params.load_state_dict(weights.dit_state_from_jax(sparams))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, m = dist.loss(state.params, state.teacher_params, tb, draws=draws)
    for name in ("loss", "t_mean", "target_v_rms"):
        np.testing.assert_allclose(float(m[name].detach()), float(jm[name]), rtol=2e-4,
                                   err_msg=name)
    loss.backward()
    want = weights.dit_state_from_jax(jg)
    worst = max((rel_l2(p.grad, want[n]), n) for n, p in state.params.named_parameters()
                if float(want[n].norm()) > 0)
    assert worst[0] <= 2e-4, worst
    assert all(p.grad is None for p in state.teacher_params.parameters())


SETTINGS = {
    "cfg_cutoff_tail": dict(steps=6, cfg_strength=2.0, sway_sampling_coef=1.0, cfg_cutoff=0.5),
    "block_cache": dict(steps=5, cfg_strength=2.0, sway_sampling_coef=1.0,
                        block_cache_range=(0, 2), block_cache_every=2),
    "midpoint_no_cfg": dict(steps=3, cfg_strength=0.0, sway_sampling_coef=None,
                            method="midpoint"),
}


@pytest.mark.parametrize("case", list(SETTINGS))
def test_return_trajectory_matches_jax(case, jmodel):
    jd, params = jmodel
    st = dict(SETTINGS[case], return_trajectory=True)
    rng = np.random.default_rng(2)
    Bs, N = 2, 64
    cond = rng.standard_normal((Bs, N, D)).astype(np.float32)
    keep = np.zeros((Bs, N), bool)
    keep[:, :20] = True
    cond = np.where(keep[..., None], cond, 0.0).astype(np.float32)
    text = rng.integers(0, V, (Bs, NT)).astype(np.int32)
    dur = np.array([64, 52], np.int32)
    y0 = rng.standard_normal((Bs, N, D)).astype(np.float32)
    jset = jsampler.SamplerSettings(**st)
    run = jsampler.make_sampler(jd, jset)
    jout, jtraj = run(params, jnp.asarray(cond), jnp.asarray(keep), jnp.asarray(text),
                      jnp.asarray(dur), jnp.asarray(y0))
    dit = DiT(DiTArch(**ARCH), mel_dim=D, text_num_embeds=V).eval()
    dit.load_state_dict(weights.dit_state_from_jax(params))
    out, traj = sampler.sample_mel(
        dit, cond=torch.from_numpy(cond), cond_mask=torch.from_numpy(keep),
        text_ids=torch.from_numpy(text), duration=torch.from_numpy(dur),
        y0=torch.from_numpy(y0), time_grid=np.asarray(jsampler.sway_time_grid(
            st["steps"], st["sway_sampling_coef"])), settings=sampler.SamplerSettings(**st))
    assert tuple(traj.shape) == tuple(jtraj.shape) == (st["steps"], Bs, N, D)
    for got, want in ((out, jout), (traj, jtraj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4 * np.abs(want).max())
    np.testing.assert_array_equal(traj[-1].numpy()[~keep], out.numpy()[~keep])


# ------------------------------------------------------------- the CLI chain
def _get(port, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, json.loads(body)


def test_train_distill_tts_evaluate_chain(tmp_path, monkeypatch):
    from lemas_tts_tpu_torch import TTS
    from lemas_tts_tpu_torch.models.speaker import SpeakerConfig, SpeakerEncoder
    from lemas_tts_tpu_torch.scripts import distill, evaluate, serve_http, train
    from lemas_tts_tpu_torch.utils.audio_io import write_wav

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join([" "] + list("abcdefghijklmnopqrstuvwxyz") + [",", ".", "!"])
                     + "\n")
    ck, log = tmp_path / "ck", tmp_path / "log.jsonl"
    common = ["--config", TINY, "--vocab_file", str(vocab), "--synthetic", "6", "--device",
              "cpu", "--log_every", "1", "--log_file", str(log)]
    assert train.main([*common, "--ckpt_dir", str(ck), "--steps", "2"]) == 0
    assert train.main([*common, "--ckpt_dir", str(ck), "--steps", "3", "--resume",
                       "--checkpoint_activations"]) == 0
    events = [json.loads(line) for line in log.read_text().splitlines()]
    assert any(e["event"] == "resumed" and e["step"] == 2 for e in events)
    assert [e["step"] for e in events if e["event"] == "train_step"] == [1, 2, 3]
    assert all(np.isfinite(e["loss"]) for e in events if e["event"] == "train_step")

    dd, dw = tmp_path / "dd", tmp_path / "dw"
    dcommon = ["--config", TINY, "--vocab_file", str(vocab), "--synthetic", "4", "--device",
               "cpu", "--teacher", str(ck), "--steps_per_stage", "1", "--log_file", str(log)]
    assert distill.main([*dcommon, "--stages", "4,2", "--ckpt_dir", str(dd)]) == 0
    assert distill.main([*dcommon, "--stages", "4", "--ckpt_dir", str(dw), "--student_heads",
                         "2", "--student_dim_head", "32", "--block_cache", "0-2:2"]) == 0
    meta = json.loads((dw / "stage_4" / "student.json").read_text())
    assert meta["arch"] == {"heads": 2, "dim_head": 32} and meta["block_cache"] == "0-2:2"
    assert json.loads((dd / "stage_2" / "student.json").read_text())["student_steps"] == 2

    rng = np.random.default_rng(0)
    ref = (0.2 * np.sin(2 * np.pi * 180 * np.arange(8000) / 8000)
           + 0.02 * rng.standard_normal(8000)).astype(np.float32)
    write_wav(str(tmp_path / "ref.wav"), ref, 8000)
    rows = []
    for stage, heads, steps in ((dd / "stage_2", 4, 2), (dw / "stage_4", 2, 4)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tts = TTS(model=TINY, ckpt_file=str(stage), vocab_file=str(vocab), frontend=None,
                      device="cpu")
        assert tts.dit.transformer_blocks[0].attn.heads == heads
        seen, infos = [], []
        real = tts.synth.synthesize_chunks
        tts.synth.synthesize_chunks = lambda *a, cfg, **k: (seen.append(cfg), real(
            *a, cfg=cfg, **k))[1]
        wave, sr, spec = tts.infer(str(tmp_path / "ref.wav"), "hello there", "general kenobi",
                                   nfe_step=32, cfg_strength=2.0, cfg_cutoff=0.5, seed=1,
                                   show_info=infos.append,
                                   file_wave=str(stage / "out.wav"))
        cfg = seen[0]
        assert (cfg.nfe_steps, cfg.cfg_strength, cfg.cfg_cutoff, cfg.sway_sampling_coef) == (
            steps, 0.0, None, 1.0)
        assert cfg.block_cache == tts.student.get("block_cache")
        assert any("pinned" in str(i) for i in infos)
        assert np.isfinite(wave).all() and wave.size > 0 and np.isfinite(spec).all()
        rows.append({"ref": str(tmp_path / "ref.wav"), "hyp": str(stage / "out.wav"),
                     "text": "general kenobi", "hyp_text": "general kenobi"})

    args = serve_http.build_parser().parse_args(
        ["--port", "0", "--model", TINY, "--ckpt_file", str(dd / "stage_2"), "--vocab_file",
         str(vocab), "--frontend", "none", "--device", "cpu", "--no_warmup"])
    ready, box = threading.Event(), []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        thread = threading.Thread(target=serve_http.serve, args=(args,),
                                  kwargs=dict(ready_event=ready, server_box=box), daemon=True)
        thread.start()
        assert ready.wait(120)
    httpd, _ = box[0]
    try:
        status, cfg = _get(httpd.server_address[1], "/config")
    finally:
        httpd.shutdown()
        thread.join(timeout=30)
    assert status == 200 and (cfg["nfe_steps"], cfg["cfg_strength"], cfg["cfg_cutoff"],
                              cfg["block_cache"]) == (2, 0.0, None, None)
    assert cfg["student"]["student_steps"] == 2

    torch.manual_seed(0)
    spk = tmp_path / "speaker.pt"
    torch.save(SpeakerEncoder(SpeakerConfig(input_dim=20, embed_dim=32)).state_dict(), spk)
    manifest = tmp_path / "eval.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    out = tmp_path / "summary.json"
    assert evaluate.main(["--manifest", str(manifest), "--config", TINY, "--out", str(out),
                          "--speaker_ckpt", str(spk), "--dtw", "--device", "cpu"]) == 0
    summary = json.loads(out.read_text())
    assert summary["n_utterances"] == 2 and summary["wer"] == 0.0
    for k in ("mel_mse", "mel_mae", "mcd_db", "speaker_cos"):
        assert np.isfinite(summary[k]), k
    # --asr transcribes only a hyp WAV without a hyp_text: every row here has one
    from lemas_tts_tpu_torch.infer import asr

    def no_asr(*_, **__):
        raise AssertionError("evaluate --asr transcribed a row that has a hyp_text")

    monkeypatch.setattr(asr, "transcribe", no_asr)
    assert evaluate.main(["--manifest", str(manifest), "--config", TINY, "--out", str(out),
                          "--asr", "--device", "cpu"]) == 0
    assert json.loads(out.read_text())["wer"] == 0.0
