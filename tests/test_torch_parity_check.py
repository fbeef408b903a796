"""The port's checkpoint parity harness (``scripts/parity_check.py``) on the
CPU, as ``tests/test_parity_harness.py`` pins the JAX one: a bundle
captured from the tiny random-weight model replays through a fresh ``TTS``
of the same config to ~zero mel MSE (noise and duration pinned), a
perturbed bundle trips the gate, and capture mode without the reference
repository fails with exit code 2."""

import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from lemas_tts_tpu_torch import TTS
from lemas_tts_tpu_torch.config import SamplerConfig
from lemas_tts_tpu_torch.scripts import parity_check
from lemas_tts_tpu_torch.utils.audio_io import read_audio, write_wav

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"


@pytest.fixture(scope="module")
def bundle_env(tmp_path_factory):
    """A tiny TTS, its vocab and reference, and one pinned case written as a
    pseudo-reference bundle (what ``--capture`` writes)."""
    root = tmp_path_factory.mktemp("parity")
    (root / "vocab.txt").write_text("\n".join([" "] + list("abcdefghijklmnopqrstuvwxyz")) + "\n")
    sr = 8000
    t = np.arange(int(sr * 0.8)) / sr
    write_wav(str(root / "ref.wav"), (0.25 * np.sin(2 * np.pi * 200 * t)).astype(np.float32),
              sr)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = TTS(model=str(DATA / "tiny.yaml"), vocab_file=str(root / "vocab.txt"),
                  device="cpu", frontend=None)
    ref_units, gen_units, duration = list("hello"), list("worldly"), 160
    noise = np.random.default_rng(3).standard_normal((duration, 20)).astype(np.float32)
    wav, wsr = read_audio(str(root / "ref.wav"))
    _, _, mel = tts.synth.synthesize_chunks(
        wav, wsr, ref_units, [gen_units],
        cfg=SamplerConfig(nfe_steps=2, cfg_strength=1.0, sway_sampling_coef=-1.0),
        noise_override=noise, duration_override=[duration])
    return root, {"mel": mel.astype(np.float32), "noise": noise, "case": {
        "name": "case0", "lang": "en", "ref_audio": str(root / "ref.wav"),
        "ref_units": ref_units, "gen_units": gen_units, "nfe": 2, "cfg_strength": 1.0,
        "sway": -1.0, "duration": duration, "mel": "case0.mel.npy",
        "noise": "case0.noise.npy"}}


def _bundle(bundle_env, path: Path, mel_offset: float = 0.0) -> Path:
    _, b = bundle_env
    path.mkdir()
    np.save(path / "case0.mel.npy", b["mel"] + mel_offset)
    np.save(path / "case0.noise.npy", b["noise"])
    (path / "captured.json").write_text(json.dumps({"cases": [b["case"]]}))
    return path


def _compare(bundle_env, bundle: Path, out: Path) -> int:
    root, _ = bundle_env
    return parity_check.main(["--bundle", str(bundle), "--model", str(DATA / "tiny.yaml"),
                              "--vocab_file", str(root / "vocab.txt"), "--device", "cpu",
                              "--out", str(out)])


def test_compare_self_consistency_passes_gate(bundle_env, tmp_path):
    out = tmp_path / "report.json"
    assert _compare(bundle_env, _bundle(bundle_env, tmp_path / "b"), out) == 0
    report = json.loads(out.read_text())
    assert report["failed_langs"] == []
    # a fresh TTS of the same config replays the pinned case bit for bit
    assert report["per_lang"]["en"]["mel_mse"] < 1e-9
    case = report["cases"][0]
    assert case["frames_ours"] == case["frames_ref"] == bundle_env[1]["mel"].shape[1]


def test_compare_flags_mismatch(bundle_env, tmp_path):
    out = tmp_path / "report.json"
    assert _compare(bundle_env, _bundle(bundle_env, tmp_path / "b", mel_offset=0.5), out) == 1
    report = json.loads(out.read_text())
    assert report["failed_langs"] == ["en"]
    assert report["per_lang"]["en"]["mel_mse"] == pytest.approx(0.25, rel=1e-3)


def test_capture_without_reference_repo_fails_loudly(tmp_path, capsys):
    manifest = tmp_path / "cases.json"
    manifest.write_text(json.dumps({"cases": [{"name": "c"}]}))
    rc = parity_check.main(["--capture", "--manifest", str(manifest), "--bundle",
                            str(tmp_path / "out"), "--ref_repo", str(tmp_path / "absent")])
    assert rc == 2
    assert "capture mode needs torch + the reference repo" in capsys.readouterr().err
    assert parity_check.main(["--capture", "--bundle", str(tmp_path / "out")]) == 2
