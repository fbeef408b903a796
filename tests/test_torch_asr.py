"""ASR of the port (``infer/asr.py``, the transcript cache of
``infer/preprocess.py``, ``TTS.transcribe``, ``evaluate --asr``) against the
torch backend of the JAX package on the CPU.

No Whisper weights are in the repository, so the pipeline is a random-init
tiny ``WhisperForConditionalGeneration`` with its ``WhisperFeatureExtractor``
and a stub tokenizer that writes "heard" and the generated ids
(``chip_smoke.tiny_whisper_pipeline``, which the chip run uses too), put
into both packages' module caches (``_asr_pipe``), as
``tests/test_asr_flax.py`` injects the Flax components. ``transformers`` is
imported inside the fixture, with ``USE_TF=0`` (its TensorFlow import alone
takes seconds). Inputs at 16 kHz, the feature extractor's rate: the JAX
package hands other rates to the pipeline, whose resampler needs
``torchaudio`` (a dependency of neither package); the port resamples them
itself.
"""

import hashlib
import json
import os
import sys
import warnings

import numpy as np
import pytest

import torch

from lemas_tts_tpu.infer import asr as jasr
from lemas_tts_tpu.infer import preprocess as jpreprocess
from lemas_tts_tpu_torch import TTS
from lemas_tts_tpu_torch.eval.metrics import wer
from lemas_tts_tpu_torch.infer import asr, preprocess
from lemas_tts_tpu_torch.ops.resample import resample
from lemas_tts_tpu_torch.utils.audio_io import write_wav

TINY = "tests/data/tiny.yaml"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def whisper():
    """The tiny pipeline on the CPU."""
    old = os.environ.get("USE_TF")
    os.environ["USE_TF"] = "0"
    try:
        import chip_smoke

        return chip_smoke.tiny_whisper_pipeline("cpu")
    finally:
        if old is None:
            os.environ.pop("USE_TF", None)
        else:
            os.environ["USE_TF"] = old


@pytest.fixture
def injected(whisper, monkeypatch):
    """The same pipeline in both packages' caches, fresh transcript caches."""
    monkeypatch.delenv("LEMAS_ASR_BACKEND", raising=False)
    monkeypatch.setattr(asr, "_asr_pipe", whisper)
    monkeypatch.setattr(jasr, "_asr_pipe", whisper)
    monkeypatch.setattr(preprocess, "_ref_audio_cache", {})
    monkeypatch.setattr(jpreprocess, "_ref_audio_cache", {})
    return whisper


def _wave(seed: int, n: int = 16000) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-0.3, 0.3, n).astype(np.float32)


@pytest.mark.parametrize("language", [None, "en"])
def test_transcribe_matches_jax(injected, language, tmp_path):
    """The same string from both packages' ``transcribe`` on one pipeline
    (with and without a language). Without one: a WAV path reads to the
    same, and another rate is resampled by the port's resampler before the
    pipeline."""
    wav = _wave(0)
    got = asr.transcribe((wav, 16000), language, device="cpu")
    assert got == jasr.transcribe((wav, 16000), language)
    assert got.startswith("heard") and got == got.strip()
    if language is not None:
        return
    path = tmp_path / "ref.wav"
    write_wav(str(path), wav, 16000)
    assert asr.transcribe(str(path), device="cpu") == got
    slow = _wave(1, 8000)
    up = resample(torch.from_numpy(slow), 8000, 16000).numpy()
    assert asr.transcribe((slow, 8000), device="cpu") == jasr.transcribe((up, 16000))


def test_pipeline_stays_on_the_callers_device(injected):
    """A kept pipeline on the CPU is not used for a request on CUDA: without
    a card the request fails, it does not run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        asr.transcribe((_wave(0), 16000))
    assert asr.initialize_asr_pipeline("cpu") is injected


def test_transformers_missing_or_flax_backend_raise(injected, monkeypatch):
    """No fallback: without ``transformers`` an ``ImportError`` names it, in
    ``transcribe`` and through ``TTS.infer`` with an empty ``ref_text``;
    ``LEMAS_ASR_BACKEND=flax`` (Flax Whisper runs on JAX) is refused."""
    monkeypatch.setattr(asr, "_asr_pipe", None)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        asr.transcribe((_wave(0), 16000), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = TTS(model=TINY, frontend=None, device="cpu")
    with pytest.raises(ImportError, match="transformers"):
        tts.infer((_wave(2), 16000), "", "hello", nfe_step=2, show_info=lambda *_: None)
    monkeypatch.setenv("LEMAS_ASR_BACKEND", "flax")
    with pytest.raises(NotImplementedError, match="flax"):
        asr.transcribe((_wave(0), 16000), device="cpu")


def test_ref_text_cache_matches_jax(injected):
    """md5 over ``f"{sr}:"`` and the wave's bytes; one call for a repeated
    audio, another for the same bytes at another rate; the FIFO drops the
    oldest of 256; the results and the caches equal the JAX package's with
    the same ``transcribe_fn``."""
    calls = {"port": [], "jax": []}

    def fn(side):
        def transcribe_fn(wav, sr):
            calls[side].append(sr)
            return f"words at {sr}"
        return transcribe_fn

    quiet = lambda *_: None  # noqa: E731
    wav = _wave(3, 20000)
    for sr in (16000, 16000, 22050):
        got = preprocess.preprocess_ref_audio_text((wav, sr), "", show_info=quiet,
                                                   transcribe_fn=fn("port"))
        want = jpreprocess.preprocess_ref_audio_text((wav, sr), "", show_info=quiet,
                                                     transcribe_fn=fn("jax"))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] == (sr, f"words at {sr}. ")
    assert calls["port"] == calls["jax"] == [16000, 22050]
    assert preprocess._ref_audio_cache == jpreprocess._ref_audio_cache
    clipped = got[0]
    key = hashlib.md5(b"22050:" + clipped.tobytes()).hexdigest()
    assert list(preprocess._ref_audio_cache)[-1] == key
    for cache in (preprocess._ref_audio_cache, jpreprocess._ref_audio_cache):
        cache.clear()
        cache.update({f"k{i}": "x" for i in range(preprocess.CACHE_SIZE)})
    assert preprocess.CACHE_SIZE == 256
    preprocess.preprocess_ref_audio_text((wav, 16000), "", show_info=quiet,
                                         transcribe_fn=fn("port"))
    jpreprocess.preprocess_ref_audio_text((wav, 16000), "", show_info=quiet,
                                          transcribe_fn=fn("jax"))
    assert preprocess._ref_audio_cache == jpreprocess._ref_audio_cache
    assert len(preprocess._ref_audio_cache) == 256 and "k0" not in preprocess._ref_audio_cache


def test_tts_transcribes_an_empty_ref_text(injected):
    """``TTS.transcribe`` on the ``TTS``'s device gives the JAX string;
    ``TTS.infer`` with an empty ``ref_text`` transcribes the reference once
    (the pipeline by default, or an injected ``transcribe_fn``) and
    synthesizes."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = TTS(model=TINY, frontend=None, device="cpu")
    wav = _wave(4)
    text = tts.transcribe((wav, 16000), language="en")
    assert text == jasr.transcribe((wav, 16000), "en")
    said = []
    out = tts.infer((wav, 16000), "", "hello", nfe_step=2, seed=0, show_info=said.append)
    assert any("transcribing" in s for s in said)
    assert np.isfinite(out[0]).all() and out[0].size > 0
    said.clear()
    tts.infer((wav, 16000), "", "hello", nfe_step=2, seed=0, show_info=said.append,
              transcribe_fn=lambda *_: pytest.fail("the transcript was not cached"))
    assert any("cached" in s for s in said)


def test_evaluate_asr_transcribes_hyp_without_text(injected, tmp_path):
    """``evaluate --asr`` scores a hyp WAV that has no ``hyp_text`` by its
    transcript (the JAX CLI's rule); a row with ``hyp_text`` keeps it."""
    from lemas_tts_tpu_torch.scripts import evaluate

    ref, hyp = tmp_path / "ref.wav", tmp_path / "hyp.wav"
    write_wav(str(ref), _wave(5, 8000), 8000)
    write_wav(str(hyp), _wave(6, 8000), 8000)
    heard = asr.transcribe((_wave(6, 8000), 8000), device="cpu")
    rows = [{"ref": str(ref), "hyp": str(hyp), "text": "general kenobi"},
            {"ref": str(ref), "hyp": str(hyp), "text": "general kenobi",
             "hyp_text": "general kenobi"}]
    manifest = tmp_path / "eval.jsonl"
    manifest.write_text("".join(json.dumps(r) + "\n" for r in rows))
    per_utt = tmp_path / "per_utt.jsonl"
    assert evaluate.main(["--manifest", str(manifest), "--config", TINY, "--asr",
                          "--device", "cpu", "--per_utt", str(per_utt)]) == 0
    got = [json.loads(line) for line in per_utt.read_text().splitlines()]
    assert [r["wer"] for r in got] == [wer("general kenobi", heard), 0.0]
    assert evaluate.main(["--manifest", str(manifest), "--config", TINY, "--device", "cpu",
                          "--per_utt", str(per_utt)]) == 0
    assert "wer" not in json.loads(per_utt.read_text().splitlines()[0])
