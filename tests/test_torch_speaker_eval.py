"""The port's speaker encoder and evaluation metrics against the JAX package
on the CPU.

- ``SpeakerEncoder`` (BN-TDNN, SE-Res2Net, attentive statistics pooling)
  at tiny widths, weights and BatchNorm statistics carried over
  (``weights.speaker_state_from_jax``): the embedding in eval mode, and in
  train mode the embedding and the moved running statistics (flax's
  momentum 0.9 toward the biased batch variance).
- Every metric: masked mel MSE/MAE, spectral convergence and log-STFT MAE,
  mel cepstra, MCD with and without DTW, speaker cosine, WER and CER.
- ``scripts/evaluate.main`` on WAV and ``.npy`` pairs gives the JAX CLI's
  summary.

Tolerance: f32, rtol 2e-4 (atol 2e-5 of the peak for arrays).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lemas_tts_tpu.eval import metrics as jm
from lemas_tts_tpu.models import speaker as jspk
from lemas_tts_tpu_torch import weights
from lemas_tts_tpu_torch.eval import metrics
from lemas_tts_tpu_torch.models import speaker

TINY = dict(input_dim=12, embed_dim=32, channels=(16, 16, 16, 48), kernel_sizes=(5, 3, 3, 1),
            dilations=(1, 2, 3, 1), attention_channels=8, res2net_scale=4, se_channels=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=2e-4, atol=2e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def encoders():
    jenc = jspk.SpeakerEncoder(cfg=jspk.SpeakerConfig(**TINY))
    x = jnp.asarray(np.random.default_rng(0).standard_normal((3, 40, 12)), jnp.float32)
    variables = jenc.init(jax.random.key(0), x)
    # non-trivial BatchNorm statistics: one train-mode pass moves them
    _, stats = jenc.apply(variables, x * 1.5 + 0.3, train=True, mutable=["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats["batch_stats"]}
    enc = speaker.SpeakerEncoder(speaker.SpeakerConfig(**TINY))
    enc.load_state_dict(weights.speaker_state_from_jax(variables))
    return jenc, variables, enc


@pytest.mark.parametrize("train", [False, True])
def test_speaker_encoder_matches_jax(train, encoders):
    """Train mode normalises by batch statistics, here over 4 rows: the
    pooled BatchNorm's fast variance over 2 rows cancels to a few f32 ulps
    of E[x²] in both packages (each then lies ~1e-5 from an f64 run)."""
    jenc, variables, enc = encoders
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 33, 12)) * np.arange(1, 5)[:, None, None]).astype(np.float32)
    if not train:
        close(enc(torch.from_numpy(x)), jenc.apply(variables, jnp.asarray(x)))
        return
    import copy

    enc = copy.deepcopy(enc)
    want, mutated = jenc.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    close(enc(torch.from_numpy(x), train=True), want)
    moved = weights.speaker_state_from_jax({"params": variables["params"],
                                            "batch_stats": mutated["batch_stats"]})
    sd = enc.state_dict()
    for k, v in moved.items():
        if "running" in k:
            close(sd[k], v, atol=1e-6)


def _mels():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 30, 20)).astype(np.float32)
    return a, a + 0.3 * rng.standard_normal(a.shape).astype(np.float32)


@pytest.mark.parametrize("name", ["mel_mse", "mel_mae"])
def test_mel_errors_match_jax(name):
    a, b = _mels()
    for lengths in (None, np.array([30, 17])):
        close(getattr(metrics, name)(a, b, lengths), getattr(jm, name)(a, b, lengths))


def test_spectral_distance_matches_jax():
    rng = np.random.default_rng(4)
    wa = rng.standard_normal((2, 4000)).astype(np.float32)
    wb = (wa + 0.1 * rng.standard_normal((2, 4100))[:, :4000]).astype(np.float32)
    for got, want in zip(metrics.spectral_distance(wa, wb, 256, 64),
                         jm.spectral_distance(wa, wb, 256, 64)):
        close(got, want)


@pytest.mark.parametrize("dtw", [False, True])
def test_cepstra_and_mcd_match_jax(dtw):
    a, b = _mels()
    close(metrics.mel_cepstra(a[0], 13), jm.mel_cepstra(jnp.asarray(a[0]), 13))
    np.testing.assert_allclose(metrics.mcd(a[0], b[0, :24], use_dtw=dtw),
                               jm.mcd(a[0], b[0, :24], use_dtw=dtw), rtol=2e-4)


def test_speaker_similarity_matches_jax(encoders):
    jenc, variables, enc = encoders
    a, b = (np.random.default_rng(s).standard_normal((25, 12)).astype(np.float32)
            for s in (5, 6))
    np.testing.assert_allclose(metrics.speaker_similarity(enc, a, b),
                               jm.speaker_similarity(jenc, variables, a, b), rtol=2e-4)
    assert abs(metrics.speaker_similarity(enc, a, a) - 1.0) < 1e-5


@pytest.mark.parametrize("ref,hyp", [("hello there", "hello here"), ("", ""), ("", "a b"),
                                     ("The Cat  sat", "the cat sat on")])
def test_wer_cer_match_jax(ref, hyp):
    assert metrics.wer(ref, hyp) == jm.wer(ref, hyp)
    assert metrics.cer(ref, hyp) == jm.cer(ref, hyp)


def test_evaluate_cli_matches_jax(tmp_path):
    from lemas_tts_tpu.scripts import evaluate as jevaluate
    from lemas_tts_tpu_torch.scripts import evaluate
    from lemas_tts_tpu_torch.utils.audio_io import write_wav

    sr = 8000
    t = np.arange(sr) / sr
    write_wav(str(tmp_path / "ref.wav"), (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
              sr)
    write_wav(str(tmp_path / "hyp.wav"), (0.3 * np.sin(2 * np.pi * 230 * t)).astype(np.float32),
              16000)  # resampled to the config's rate
    np.save(tmp_path / "mel.npy", np.random.default_rng(0).standard_normal((40, 20))
            .astype(np.float32))
    rows = [{"ref": str(tmp_path / "ref.wav"), "hyp": str(tmp_path / "hyp.wav"),
             "text": "hello there", "hyp_text": "hello here"},
            {"ref": str(tmp_path / "mel.npy"), "hyp": str(tmp_path / "ref.wav")}]
    man = tmp_path / "eval.jsonl"
    man.write_text("".join(json.dumps(r) + "\n" for r in rows))
    args = ["--manifest", str(man), "--config", "tests/data/tiny.yaml", "--dtw"]
    assert jevaluate.main([*args, "--out", str(tmp_path / "j.json")]) == 0
    assert evaluate.main([*args, "--out", str(tmp_path / "t.json"), "--device", "cpu"]) == 0
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-6, err_msg=k)
