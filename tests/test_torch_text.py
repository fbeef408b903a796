"""The port's text frontend (``lemas_tts_tpu_torch/text/``) against the JAX
package's (``lemas_tts_tpu/text/``) on the CPU, under the same backends.

Exact string equality on every golden of ``tests/data/phone_goldens.json``
and every input of ``tests/test_text_extras.py`` and
``tests/test_api_frontend.py``, for ``text2phn``, ``text2norm``,
``txt2pinyin`` and ``txt2pin_phns`` in both frontends, and for the helpers.

The one intentional delta: only an exact ``#1``-``#4`` is a pause token in
the port. Where the JAX package emits a token that starts with ``#`` and is
longer than one character but is not a pause (``#:``, ``#a``, ``#,``,
``#5``, ``#winning``), the port emits the ``#`` as a token of its own;
``DELTA`` lists the listed inputs that hit it, and the Hypothesis test
checks the same rule on random text.
"""

import json
import warnings
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from lemas_tts_tpu import api as japi
from lemas_tts_tpu.text import TextNorm as JTextNorm
from lemas_tts_tpu.text import cn_tn as jcn_tn
from lemas_tts_tpu.text import detect as jdetect
from lemas_tts_tpu.text import en_ipa as jen_ipa
from lemas_tts_tpu.text import en_tn as jen_tn
from lemas_tts_tpu.text import gp2py as jgp2py
from lemas_tts_tpu.text import id_tn as jid_tn
from lemas_tts_tpu.text import latin_ipa as jlatin_ipa
from lemas_tts_tpu.text import numwords as jnumwords
from lemas_tts_tpu.text import pinyin as jpinyin
from lemas_tts_tpu_torch import api
from lemas_tts_tpu_torch.text import TextNorm
from lemas_tts_tpu_torch.text import cn_tn, detect, en_ipa, en_tn, gp2py, id_tn, latin_ipa
from lemas_tts_tpu_torch.text import numwords, pinyin, tokenizer

GOLDENS = json.loads((Path(__file__).parent / "data" / "phone_goldens.json").read_text())
PAUSES = {"#1", "#2", "#3", "#4"}

# the inputs of tests/test_text_extras.py and tests/test_api_frontend.py
LISTED = [
    "Page 2, #1 done.", "Bonjour ami.", "Hola amigo.", "#winning today", "hi #2 there",
    "你好。", "ni3 hao3 #1 shi4", "你好 world 123", "the cat is on the mat",
    "el gato está en la casa", "你好世界", "こんにちは", "Hello there, #2 general!",
    "hello мир", "привет iphone мир", "l'acqua è bella", "hola #2 mundo",
    "a1b, #3 c-d! 42", "hello there", "general kenobi", "abc def", "ghi jkl",
    "hello\nworld", "Dr. Smith paid $20 on the 3rd of May, 1997 café!",
    "gw gak tau 😂 knp 25 org dtg", "Mr. and Mrs.", "8:05", "对不起", "不是",
    "hello", "world", "abc",
]
INPUTS = [c["text"] for c in GOLDENS["cases"]] + LISTED
# (text, lang) pairs the JAX tests force a language on
FORCED = [("Page 2, #1 done.", "en"), ("Bonjour ami.", "fr"), ("Hola amigo.", "es"),
          ("#winning today", "en"), ("hi #2 there", "en")]
# listed inputs on which the JAX package glues a '#' to what follows
DELTA = {"#winning today"}


def glued(phones: str) -> list:
    """Tokens that start with '#', are longer than one character and are not
    a pause: the JAX package's fault, absent from the port's output."""
    return [t for t in phones.split("|") if t.startswith("#") and len(t) > 1 and t not in PAUSES]


@pytest.fixture(scope="module")
def norms():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {dt: (JTextNorm(dt), TextNorm(dt)) for dt in ("phone", "char")}


def _check_phones(text: str, ref: str, got: str) -> None:
    if glued(ref):
        assert text in DELTA or text.startswith("#"), (text, ref)
        assert not glued(got) and got.replace("|", "").replace("_", "") != "", got
    else:
        assert got == ref


@pytest.mark.parametrize("dtype", ["phone", "char"])
@pytest.mark.parametrize("text", INPUTS)
def test_textnorm_matches_jax(norms, dtype, text):
    jtn, tn = norms[dtype]
    _check_phones(text, jtn.text2phn(text), tn.text2phn(text))
    assert tn.text2norm(text) == jtn.text2norm(text)
    assert tn.txt2pinyin(text) == jtn.txt2pinyin(text)
    _check_phones(text, jtn.txt2pin_phns(text), tn.txt2pin_phns(text))


@pytest.mark.parametrize("dtype", ["phone", "char"])
@pytest.mark.parametrize("text,lang", FORCED)
def test_textnorm_forced_lang_matches_jax(norms, dtype, text, lang):
    jtn, tn = norms[dtype]
    _check_phones(text, jtn.text2phn(text, lang=lang), tn.text2phn(text, lang=lang))
    assert tn.text2norm(text, lang=lang) == jtn.text2norm(text, lang=lang)


@pytest.mark.parametrize("text", ["#:", "#a", "#,", "#winning today", "#5 cats"])
def test_hash_delta_splits(norms, text):
    """The intentional delta, on the inputs that show it: JAX glues the '#'
    to what follows; the port keeps it a token of its own and keeps exact
    pauses whole."""
    jtn, tn = norms["phone"]
    assert glued(jtn.text2phn(text)) or glued(jtn.txt2pin_phns(text))
    for got in (tn.text2phn(text), tn.txt2pin_phns(text), norms["char"][1].text2phn(text)):
        assert not glued(got) and "#" in got.split("|"), got
    for got in (tn.text2phn("x #1y"), tn.txt2pin_phns("x #1y")):
        assert not glued(got) and "#1" in got.split("|"), got


_FUZZ_ALPHABET = ("abcXYZ 0123456789.,!?;:()[]#|_-'\"\n\t你好世界中文数字一二三两千〇"
                  "こんにちはカタカナ한국어привет مرحبا ñüßéàç€%$¥°½。！？，、；：「」😀́​")


@settings(max_examples=60, deadline=None, database=None)
@given(st.text(alphabet=_FUZZ_ALPHABET, min_size=0, max_size=80))
def test_textnorm_matches_jax_on_random_text(text):
    """Random mixed-script text: the port equals JAX exactly, except where
    JAX emits a glued '#' token; there the port emits none."""
    for dtype in ("phone", "char"):
        jtn, tn = _fuzz_norms()[dtype]
        for fn in ("text2phn", "txt2pin_phns"):
            ref, got = getattr(jtn, fn)(text), getattr(tn, fn)(text)
            if glued(ref):
                assert not glued(got), (text, got)
            else:
                assert got == ref, (text, fn)
        assert tn.text2norm(text) == jtn.text2norm(text)


def _fuzz_norms():
    global _FUZZ
    try:
        return _FUZZ
    except NameError:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _FUZZ = {dt: (JTextNorm(dt), TextNorm(dt)) for dt in ("phone", "char")}
        return _FUZZ


@pytest.mark.parametrize("t", [0.0, 0.1, 0.5, 0.6, 1.0, 1.4, 1.6, 2.0, 2.9, 3.2, 7.0])
def test_sil_type_matches_jax(t):
    assert TextNorm.sil_type(t) == JTextNorm.sil_type(t)


SUBS = [
    [{"word": "hello", "start": 0.0, "end": 0.4}, {"word": "world", "start": 1.4, "end": 1.9},
     {"word": "bye", "start": 3.0, "end": 3.4}],
    [{"word": "hello", "start": 0.0, "end": 0.5}, {"word": "world", "start": 0.6, "end": 1.0}],
    [{"word": "a", "start": 0.7, "end": 0.9}, {"word": "b", "start": 2.5, "end": 2.8},
     {"word": "c", "start": 2.9, "end": 3.3}, {"word": "d", "start": 6.5, "end": 7.0}],
]
EDITS = [(0, 1.3, 2.0, "WORLD", "(en)", "(fr)"), (1, 0.0, 0.55, "HI", "(en)", "(en)"),
         (2, 2.4, 3.4, "x y", "(zh)", "(en)"), (0, 5.0, 6.0, "", "(en)", "(en)")]


@pytest.mark.parametrize("case", range(len(EDITS)))
def test_add_sil_and_get_prompt_match_jax(norms, case):
    (jtn, tn), (i, start, end, target, src, tar) = norms["char"], EDITS[case]
    assert tn.add_sil(SUBS[i], start, end, target, src, tar) == \
        jtn.add_sil(SUBS[i], start, end, target, src, tar)
    assert tn.get_prompt(SUBS[i], start, end, src) == jtn.get_prompt(SUBS[i], start, end, src)


PHONE_LISTS = [["(en)", "h", "ə", "_", "(zh)", "n", "i3", "_", ",", "#1"],
               ["a", "_", "(xx)", "b", ".", "_", "_", "!", "(es)", "o", "#2", "_"]] + \
    [c["phones"].split("|") for c in GOLDENS["cases"]]


@pytest.mark.parametrize("i", range(len(PHONE_LISTS)))
def test_process_phone_list_matches_jax(i):
    assert api.process_phone_list(PHONE_LISTS[i]) == japi.process_phone_list(PHONE_LISTS[i])
    assert api.LANGS == japi.LANGS and api._PUNCS == japi._PUNCS


# (port module, JAX module, function name, positional args)
HELPERS = [
    (detect, jdetect, "detect_lang", (t,)) for t in INPUTS[:24] + ["", "xin chào"]
] + [
    (numwords, jnumwords, "replace_numbers_with_words", (t, lang))
    for t in ("I have 12 cats and 3.5 dogs", "page 132, #1 not 133", "2024 年", "x 7 y")
    for lang in ("en", "es", "de", "zh", "id", "fr")
] + [
    (en_tn, jen_tn, "english_cleaners", (t,)) for t in (
        "Dr. Smith paid $20 on the 3rd of May, 1997 café!", "Mr. and Mrs. Jones, 1,000 things",
        "the 2nd time, 21st and 32nd", "  naïve   œuvre \n ok ")
] + [
    (en_tn, jen_tn, "expand_numbers", (t,)) for t in ("100", "1st", "the 2nd time", "$3.50")
] + [
    (id_tn, jid_tn, "indonesian_cleaners", (t,)) for t in (
        "gw gak tau 😂 knp 25 org dtg", "yg bgt 1500 rupiah 🙂🙂 dunia", "3.14 dan 2000000")
] + [
    (id_tn, jid_tn, "number_to_words_id", (t,)) for t in ("11", "21", "105", "1500", "3.14")
] + [
    (cn_tn, jcn_tn, "num_to_chinese", (t,)) for t in ("20034", "10000234", "7", "100")
] + [
    (pinyin, jpinyin, "apply_tone_sandhi", (w, py)) for w, py in (
        ("对不起", ["dui4", "bu5", "qi3"]), ("不是", ["bu4", "shi4"]), ("你好", ["ni3", "hao3"]),
        ("一个", ["yi1", "ge4"]))
] + [
    (pinyin, jpinyin, "is_pinyin_syllable", (s,)) for s in ("ni3", "zhong1", "lv4", "HELLO", "xq3")
] + [
    (pinyin, jpinyin, "split_syllable", (s,)) for s in ("zhong1", "ai4", "lv4", "er2")
] + [
    (en_ipa, jen_ipa, "txt2phone", (t,)) for t in ("Hello there, #2 general!", "hello мир")
] + [
    (latin_ipa, jlatin_ipa, "txt2phone", (t, lang)) for t, lang in (
        ("hola #2 mundo", "es"), ("l'acqua è bella", "it"), ("привет iphone мир", "ru"),
        ("Der schnelle braune Fuchs", "de"), ("A raposa marrom", "pt"), ("Rubah coklat", "id"))
]


@pytest.mark.parametrize("mod,jmod,name,args", HELPERS,
                         ids=[f"{h[2]}-{i}" for i, h in enumerate(HELPERS)])
def test_helper_matches_jax(mod, jmod, name, args):
    assert getattr(mod, name)(*args) == getattr(jmod, name)(*args)


@pytest.mark.parametrize("text", ["8:05", "他花了1024元买了3本书。", "会议在2025年3月15日举行",
                                  "百分之12.5% 和 3/4"])
def test_nsw_normalizer_matches_jax(text):
    assert cn_tn.NSWNormalizer().normalize(text) == jcn_tn.NSWNormalizer().normalize(text)


@pytest.mark.parametrize("text", ["你好 world 123", "小明说:Hello world,然后就走了。", "abc"])
def test_gp2py_matches_jax(text):
    assert gp2py.GP2PY().gp2py(text) == jgp2py.GP2PY().gp2py(text)


def test_pause_grammar():
    """The port's pause set is the vocab's: #1-#4, split out whole."""
    assert tokenizer.PAUSE_TOKENS == PAUSES
    assert tokenizer.split_pauses("a#1b#5c#12") == ["a", "#1", "b#5c", "#1", "2"]
