"""The plain reference against the port at tiny widths on the CPU, float32:
the serving row and the single-stream request, every stage (prep, duration,
sampler with CFG cutoff and block cache, vocoder, RMS) included."""


import numpy as np
import pytest
import torch

from portbench import check, system
from portbench import traffic as gen
from portbench.spec import Bench
from portbench.tests import tiny


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("ref"))
    cell = Bench(root).cell(tiny.CELL)
    path = root / "portbench/configs/tiny.json"
    out = {}
    for entry in ("serve", "single"):
        t = tiny.tiny_traffic(entry)
        sysm = system.build(cell, t, path, 31, "cpu")
        out[entry] = (sysm, t, gen.pool(t, 31))
    return cell, out


def _gaps(cell, sysm, t, pool, outs, reqs):
    model = check.reference_model(cell, sysm.host_weights, "cpu")
    recs = [type("R", (), {"index": r.index, "out": o})() for r, o in zip(reqs, outs)]
    return check.compare(recs, pool, model, t, "cpu")


def test_serving_rows_agree(built):
    cell, out = built
    sysm, t, pool = out["serve"]
    reqs = [r for r in pool if r.bucket == 512][:2]
    outs = sysm.synth.synthesize_requests(
        [dict(ref_wav=r.ref_wav, ref_sr=r.ref_sr, ref_units=r.ref_text, gen_units=r.chunks[0],
              seed=r.seed) for r in reqs], cfg=sysm.cfg)
    g = _gaps(cell, sysm, t, pool, outs, reqs)
    assert g["frames_off"] == 0
    assert g["mel_rel_l2"] < 2e-5 and g["wave_rel_l2"] < 2e-5, g


def test_single_stream_request_agrees(built):
    cell, out = built
    sysm, t, pool = out["single"]
    r = next(r for r in pool if len(r.chunks) == 2)
    outs = [sysm.synth.synthesize_chunks(r.ref_wav, r.ref_sr, r.ref_text, r.chunks,
                                         cfg=sysm.cfg, seed=r.seed)]
    g = _gaps(cell, sysm, t, pool, outs, [r])
    assert g["frames_off"] == 0
    assert g["mel_rel_l2"] < 2e-5 and g["wave_rel_l2"] < 2e-5, g


def test_reference_audio_front_end():
    """Resampling and the mel against the port's own front end (float32)."""
    from lemas_tts_tpu_torch.ops.mel import MelFrontend
    from lemas_tts_tpu_torch.ops.resample import resample

    from portbench.reference import audio

    x = gen.voice(16000 * 3, 16000, 0.05, np.random.default_rng(0))
    want = resample(torch.from_numpy(x), 16000, 24000).numpy()
    got = audio.resample(x, 16000, 24000)
    assert got.shape == want.shape and np.abs(got - want).max() < 1e-5
    mel = MelFrontend()(torch.from_numpy(want))[None][0].T.numpy()
    ref = audio.log_mel(got, 24000, 1024, 256, 1024, 100)
    assert mel.shape == ref.shape and np.abs(mel - ref).max() < 1e-3
