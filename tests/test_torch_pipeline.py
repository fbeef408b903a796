"""The slice as a whole: the port's ``TTS`` / ``Synthesizer`` against the JAX
package's on the CPU.

Both are built from ``tests/data/tiny.yaml`` with ``frontend=None``; the
port's weights are carried over from the JAX ones. ``synthesize_chunks`` runs
with the same ``noise_override`` (the two packages draw different noise from
the same seed, an intentional delta), CFG on, a few NFE steps, once with and
once without ``cfg_cutoff``. The JAX side on the CPU runs its plain ``xla``
path. f32 throughout; tolerance 2e-4 of each output's peak: a few ODE steps
of a two-block DiT and the exp-magnitude vocoder, summed in another order.
"""

import numpy as np
import pytest

import torch

from lemas_tts_tpu import TTS as JTTS
from lemas_tts_tpu.config import SamplerConfig as JSamplerConfig
from lemas_tts_tpu_torch import TTS
from lemas_tts_tpu_torch import weights
from lemas_tts_tpu_torch.config import SamplerConfig
from lemas_tts_tpu_torch.infer import pipeline
from lemas_tts_tpu_torch.utils.audio_io import write_wav

TINY = "tests/data/tiny.yaml"


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    vocab = d / "vocab.txt"
    vocab.write_text("\n".join([" "] + list("abcdefghijklmnopqrstuvwxyz") + [",", ".", "!"])
                     + "\n")
    with pytest.warns(UserWarning):
        jtts = JTTS(model=TINY, vocab_file=str(vocab), frontend=None, device="cpu")
        tts = TTS(model=TINY, vocab_file=str(vocab), frontend=None, device="cpu")
    tts.load_weights(weights.dit_state_from_jax(jtts.synth.dit_params),
                     weights.vocos_state_from_jax(jtts.synth.vocoder_params))
    return jtts, tts, d


@pytest.mark.parametrize("cfg_cutoff", [None, 0.5])
def test_synthesize_chunks_matches_jax(pair, cfg_cutoff):
    jtts, tts, _ = pair
    rng = np.random.default_rng(0)
    # broadband reference: a pure tone leaves mel bins at the 1e-5 floor, whose
    # log amplifies FFT rounding (1e-7) into differences of 5e-2
    ref = (0.2 * np.sin(2 * np.pi * 180 * np.arange(12000) / 16000)
           + 0.05 * rng.standard_normal(12000)).astype(np.float32)
    noise = rng.standard_normal((512, 20)).astype(np.float32)
    kw = dict(nfe_steps=4, cfg_strength=2.0, sway_sampling_coef=1.0, cfg_cutoff=cfg_cutoff,
              max_duration=512)
    args = (ref, 16000, "hello there. ", ["general kenobi.", "you are a bold one."])
    jw, jsr, jmel = jtts.synth.synthesize_chunks(*args, cfg=JSamplerConfig(**kw), seed=3,
                                                 noise_override=noise)
    w, sr, mel = tts.synth.synthesize_chunks(*args, cfg=SamplerConfig(**kw), seed=3,
                                             noise_override=noise)
    assert sr == jsr and mel.shape == jmel.shape and w.shape == jw.shape
    np.testing.assert_allclose(mel, jmel, rtol=2e-4, atol=2e-4 * np.abs(jmel).max())
    np.testing.assert_allclose(w, jw, rtol=2e-4, atol=2e-4 * np.abs(jw).max())


def test_cfg_cutoff_changes_the_trajectory(pair):
    """The static prefix/tail split really runs: a cutoff that ends CFG early
    gives another mel than full CFG, with the same noise."""
    _, tts, _ = pair
    ref = (0.2 * np.sin(2 * np.pi * 180 * np.arange(8000) / 8000)).astype(np.float32)
    noise = np.random.default_rng(1).standard_normal((256, 20)).astype(np.float32)
    out = [tts.synth.synthesize_chunks(ref, 8000, "ab. ", ["abc."], seed=0, noise_override=noise,
                                       cfg=SamplerConfig(nfe_steps=4, cfg_strength=2.0,
                                                         sway_sampling_coef=1.0,
                                                         cfg_cutoff=c))[2]
           for c in (None, 1.5)]
    assert out[0].shape == out[1].shape and not np.allclose(out[0], out[1])


def test_infer_end_to_end_seeded(pair):
    """TTS.infer on the CPU: a WAV reference at another rate, raw-string
    text, torch-seeded noise: finite, deterministic for a seed."""
    _, tts, d = pair
    t = np.arange(16000) / 16000
    write_wav(str(d / "ref.wav"), (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 16000)
    w1, sr, spec = tts.infer(str(d / "ref.wav"), "hello there", "general kenobi", nfe_step=4,
                             seed=11, show_info=lambda *_: None, file_wave=str(d / "out.wav"))
    w2, _, _ = tts.infer(str(d / "ref.wav"), "hello there", "general kenobi", nfe_step=4,
                         seed=11, show_info=lambda *_: None)
    assert sr == 8000 and spec.shape[0] == 20 and w1.size > 0 and np.isfinite(w1).all()
    np.testing.assert_array_equal(w1, w2)
    assert (d / "out.wav").is_file()


def test_estimate_bucket_matches_dispatch(pair):
    """estimate_bucket predicts the bucket the dispatch path uses, through
    the resampler's ceil length."""
    _, tts, _ = pair
    ref = np.zeros(16001, np.float32)
    cfg = SamplerConfig()
    b = tts.synth.estimate_bucket(ref, 16000, "hello. ", "x" * 150, cfg)
    n_model = int(np.ceil(16001 * 8000 / 16000))
    dur = pipeline.estimate_duration_frames(n_model // 64, 7, 150, 1.0)
    assert b == pipeline.pick_bucket(max(dur, 7 + 150 + 1, n_model // 64 + 2))


def test_chunk_text_and_cross_fade():
    text = "Hello world. This is a test! Short. " + "x" * 50 + ". End."
    chunks = pipeline.chunk_text(text, max_chars=30)
    assert "".join(chunks).replace(" ", "") == text.replace(" ", "")
    a, b = np.ones(100, np.float32), np.zeros(100, np.float32)
    out = pipeline.cross_fade_concat([a, b], sample_rate=100, cross_fade_duration=0.2)
    assert len(out) == 180 and (np.diff(out[80:100]) <= 0).all()


def test_empty_ref_text_needs_asr(pair, monkeypatch):
    """An empty ``ref_text`` needs ASR, which is ported (``infer/asr.py``):
    without ``transformers`` it raises an ``ImportError`` naming it, with no
    fallback; an injected ``transcribe_fn`` supplies the text, which the
    request then uses as the JAX package's does."""
    import sys

    from lemas_tts_tpu_torch.infer import asr, preprocess

    _, tts, _ = pair
    ref = (np.ones(8000, np.float32), 8000)
    monkeypatch.setattr(asr, "_asr_pipe", None)
    monkeypatch.setattr(preprocess, "_ref_audio_cache", {})
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        tts.infer(ref, "", "hello", nfe_step=2, show_info=lambda *_: None)
    heard, units = [], []
    run = tts.synth.synthesize_chunks
    monkeypatch.setattr(tts.synth, "synthesize_chunks",
                        lambda *a, **kw: units.append(a[2]) or run(*a, **kw))
    wave, sr, _ = tts.infer(ref, "", "hello", nfe_step=2, seed=0, show_info=lambda *_: None,
                            transcribe_fn=lambda w, r: heard.append(r) or "general kenobi")
    assert heard == [8000] and units == ["general kenobi. "]
    assert sr == 8000 and wave.size > 0 and np.isfinite(wave).all()
