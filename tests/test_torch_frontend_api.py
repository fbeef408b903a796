"""The port's ``TTS`` with its text frontend wired in, against the JAX
package's on the CPU.

Both are built from ``tests/data/tiny.yaml`` with ``frontend="phone"`` on a
phone/char vocab; the port's weights are carried over from the JAX ones. The
units ``prepare_units`` gives and the units ``infer`` hands to
``synthesize_chunks`` (phone, char, ``separate_langs``, a multi-line
``gen_text``) must equal JAX's exactly; ``synthesize_chunks`` on those units
with the same ``noise_override`` agrees within 2e-4 of each output's peak
(f32; the tolerance of ``tests/test_torch_pipeline.py``).
"""

import warnings

import numpy as np
import pytest

from lemas_tts_tpu import TTS as JTTS
from lemas_tts_tpu.api import process_phone_list
from lemas_tts_tpu.config import SamplerConfig as JSamplerConfig
from lemas_tts_tpu.text import TextNorm as JTextNorm
from lemas_tts_tpu_torch import TTS
from lemas_tts_tpu_torch import weights
from lemas_tts_tpu_torch.config import SamplerConfig
from lemas_tts_tpu_torch.text import TextNorm
from lemas_tts_tpu_torch.utils.audio_io import write_wav

TINY = "tests/data/tiny.yaml"
REF_TEXT = "hello there"
GEN_TEXTS = ["general kenobi, you are a bold one.", "the cat is on the mat\nel gato está aquí",
             "hello #2 world"]
CASES = [("phone", False, 0), ("phone", True, 1), ("char", False, 0), ("char", True, 1),
         ("phone", False, 2)]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("frontend")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnorm = {dt: JTextNorm(dt) for dt in ("phone", "char")}
    # every unit JAX's frontends give these texts (as the reference text gets
    # its ". " before the frontend), in both forms
    units = set()
    for t in [REF_TEXT + ". "] + [x for g in GEN_TEXTS for x in g.split("\n")]:
        lang, norm = jnorm["char"].text2norm(t + ". ")
        for seq in (jnorm["phone"].text2phn(t + ". ").split("|"), [f"({lang})"] + list(norm)):
            units |= set(seq) | set(process_phone_list(seq))
    vocab = d / "vocab.txt"
    vocab.write_text("\n".join([" "] + sorted(units - {" "})) + "\n")
    with pytest.warns(UserWarning):
        jtts = JTTS(model=TINY, vocab_file=str(vocab), frontend="phone", device="cpu")
        tts = TTS(model=TINY, vocab_file=str(vocab), device="cpu")
    tts.load_weights(weights.dit_state_from_jax(jtts.synth.dit_params),
                     weights.vocos_state_from_jax(jtts.synth.vocoder_params))
    rng = np.random.default_rng(0)
    ref = (0.2 * np.sin(2 * np.pi * 180 * np.arange(8000) / 8000)
           + 0.05 * rng.standard_normal(8000)).astype(np.float32)
    write_wav(str(d / "ref.wav"), ref, 8000)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port_norm = {dt: TextNorm(dt) for dt in ("phone", "char")}
    return jtts, tts, jnorm, port_norm, d


def _use(pair, dtype):
    jtts, tts, jnorm, port_norm, _ = pair
    jtts.frontend, tts.frontend = jnorm[dtype], port_norm[dtype]
    return jtts, tts


def _infer_units(tts, ref_path, gen_text, separate_langs):
    """The (ref units, gen chunks) ``infer`` hands to ``synthesize_chunks``."""
    seen = {}

    def capture(wav, sr, ref_units, gen_chunks, cfg=None, seed=None):
        seen.update(ref=ref_units, gen=gen_chunks)
        return np.zeros(8, np.float32), sr, np.zeros((20, 1), np.float32)

    real, tts.synth.synthesize_chunks = tts.synth.synthesize_chunks, capture
    try:
        tts.infer(ref_path, REF_TEXT, gen_text, separate_langs=separate_langs, nfe_step=2,
                  seed=1, show_info=lambda *_: None)
    finally:
        tts.synth.synthesize_chunks = real
    return seen["ref"], seen["gen"]


@pytest.mark.parametrize("dtype", ["phone", "char"])
@pytest.mark.parametrize("text", [REF_TEXT] + GEN_TEXTS + ["你好，世界。", "b #1 c"])
def test_prepare_units_match_jax(pair, dtype, text):
    jtts, tts = _use(pair, dtype)
    assert tts.prepare_units(text) == jtts.prepare_units(text)


def test_prepare_units_hash_delta(pair):
    """The one intentional delta (``text/__init__.py``): JAX glues "#a" and
    "#1c" into tokens; the port's units hold "#" and "#1" on their own."""
    jtts, tts = _use(pair, "phone")
    ref, got = jtts.prepare_units("#a b #1c"), tts.prepare_units("#a b #1c")
    assert "#a b " in ref and "#" in got and "#1" in got
    assert not [u for u in got if u.startswith("#") and u not in ("#", "#1", "#2", "#3", "#4")]


@pytest.mark.parametrize("dtype,separate_langs,g", CASES)
def test_infer_units_match_jax(pair, dtype, separate_langs, g):
    jtts, tts = _use(pair, dtype)
    ref_path = str(pair[4] / "ref.wav")
    got = _infer_units(tts, ref_path, GEN_TEXTS[g], separate_langs)
    want = _infer_units(jtts, ref_path, GEN_TEXTS[g], separate_langs)
    assert got == want
    assert len(got[1]) == len(GEN_TEXTS[g].split("\n"))  # one chunk per line
    assert all(u in tts.vocab.char_map for u in got[0] + [u for c in got[1] for u in c])


@pytest.mark.parametrize("dtype,separate_langs,g", CASES[:3])
def test_synthesize_on_frontend_units_matches_jax(pair, dtype, separate_langs, g):
    jtts, tts = _use(pair, dtype)
    ref_units, gen_chunks = _infer_units(tts, str(pair[4] / "ref.wav"), GEN_TEXTS[g],
                                         separate_langs)
    rng = np.random.default_rng(g)
    ref = (0.2 * np.sin(2 * np.pi * 180 * np.arange(8000) / 8000)
           + 0.05 * rng.standard_normal(8000)).astype(np.float32)
    noise = rng.standard_normal((512, 20)).astype(np.float32)
    kw = dict(nfe_steps=3, cfg_strength=2.0, sway_sampling_coef=1.0, max_duration=512)
    args = (ref, 8000, ref_units, gen_chunks)
    jw, jsr, jmel = jtts.synth.synthesize_chunks(*args, cfg=JSamplerConfig(**kw), seed=3,
                                                 noise_override=noise)
    w, sr, mel = tts.synth.synthesize_chunks(*args, cfg=SamplerConfig(**kw), seed=3,
                                             noise_override=noise)
    assert sr == jsr and mel.shape == jmel.shape and w.shape == jw.shape
    np.testing.assert_allclose(mel, jmel, rtol=2e-4, atol=2e-4 * np.abs(jmel).max())
    np.testing.assert_allclose(w, jw, rtol=2e-4, atol=2e-4 * np.abs(jw).max())


def test_infer_phone_end_to_end_with_spectrogram(pair):
    """``infer`` on the phone frontend, seeded: finite, deterministic, and
    ``file_wave``/``file_spec`` written."""
    _, tts = _use(pair, "phone")
    d = pair[4]
    out = [tts.infer(str(d / "ref.wav"), REF_TEXT, GEN_TEXTS[1], nfe_step=2, seed=5,
                     separate_langs=True, show_info=lambda *_: None,
                     file_wave=str(d / "o.wav"), file_spec=str(d / "o.png"))
           for _ in range(2)]
    (w1, sr, spec), (w2, _, _) = out
    assert sr == 8000 and spec.shape[0] == 20 and w1.size > 0 and np.isfinite(w1).all()
    np.testing.assert_array_equal(w1, w2)
    assert (d / "o.wav").is_file() and (d / "o.png").stat().st_size > 0


def test_byte_vocab_takes_the_raw_path(tmp_path):
    """No vocab file: the byte tokenizer cannot map unit lists, so
    ``prepare_units`` and ``infer`` keep the raw string, as in JAX."""
    with pytest.warns(UserWarning):
        tts = TTS(model=TINY, device="cpu")
    assert tts.vocab.char_map is None and tts.frontend.dtype == "phone"
    assert tts.prepare_units("hello") == "hello"
    ref = (0.3 * np.sin(2 * np.pi * 220 * np.arange(8000) / 8000)).astype(np.float32)
    w, sr, _ = tts.infer((ref, 8000), "abc def", "hello world", nfe_step=2, seed=4,
                         separate_langs=True, show_info=lambda *_: None)
    assert sr == 8000 and w.size > 0 and np.isfinite(w).all()
