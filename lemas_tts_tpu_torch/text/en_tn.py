"""English text normalization (reference ``text_norm/en_tn.py`` capability:
Keith-Ito-style cleaners — abbreviation expansion, number reading, whitespace
collapse, ASCII transliteration). Pure Python: ``inflect``/``unidecode`` are
used when installed, with built-in fallbacks."""

from __future__ import annotations

import re
import unicodedata

from lemas_tts_tpu_torch.text.numwords import number_to_words

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"),
        ("st", "saint"), ("co", "company"), ("jr", "junior"),
        ("maj", "major"), ("gen", "general"), ("drs", "doctors"),
        ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
        ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"),
        ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]

_ORDINAL_SUFFIX = re.compile(r"\b(\d+)(st|nd|rd|th)\b")
_CURRENCY = re.compile(r"\$(\d+(?:\.\d+)?)")
_COMMA_NUM = re.compile(r"(\d),(\d)")
_WS = re.compile(r"\s+")

_ORDINAL_WORDS = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _ordinalize(words: str) -> str:
    parts = words.split()
    # hyphenated compounds ordinalize their LAST component:
    # "twenty-one" → "twenty-first", not "twenty-oneth"
    hyphen = parts[-1].split("-")
    last = hyphen[-1]
    if last in _ORDINAL_WORDS:
        last = _ORDINAL_WORDS[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    parts[-1] = "-".join(hyphen[:-1] + [last])
    return " ".join(parts)


def expand_abbreviations(text: str) -> str:
    for pat, full in _ABBREVIATIONS:
        text = pat.sub(full, text)
    return text


def expand_numbers(text: str) -> str:
    try:
        import inflect  # optional, like the reference

        eng = inflect.engine()

        def num(m):
            return eng.number_to_words(m.group(0)).replace(",", "")

        text = _COMMA_NUM.sub(r"\1\2", text)
        text = _CURRENCY.sub(  # group(1): the digits, not the '$' sign
            lambda m: eng.number_to_words(m.group(1)).replace(",", "")
            + " dollars", text
        )
        text = _ORDINAL_SUFFIX.sub(
            lambda m: eng.number_to_words(m.group(0)), text
        )
        return re.sub(r"\b\d+(?:\.\d+)?\b", num, text)
    except ImportError:
        pass
    text = _COMMA_NUM.sub(r"\1\2", text)
    text = _CURRENCY.sub(
        lambda m: number_to_words(m.group(1), "en") + " dollars", text
    )
    text = _ORDINAL_SUFFIX.sub(
        lambda m: _ordinalize(number_to_words(m.group(1), "en")), text
    )
    return re.sub(
        r"\b\d+(?:\.\d+)?\b", lambda m: number_to_words(m.group(0), "en"), text
    )


def transliterate(text: str) -> str:
    try:
        from unidecode import unidecode  # optional

        return unidecode(text)
    except ImportError:
        # ligatures/letters NFKD won't decompose
        for src, dst in (("œ", "oe"), ("Œ", "OE"), ("æ", "ae"), ("Æ", "AE"),
                         ("ø", "o"), ("Ø", "O"), ("ß", "ss"), ("ð", "d"),
                         ("þ", "th"), ("đ", "d"), ("ł", "l"), ("Ł", "L")):
            text = text.replace(src, dst)
        return (
            unicodedata.normalize("NFKD", text)
            .encode("ascii", "ignore")
            .decode("ascii")
        )


def collapse_whitespace(text: str) -> str:
    return _WS.sub(" ", text).strip()


def english_cleaners(text: str) -> str:
    """Full pipeline: transliterate → lowercase → numbers → abbreviations →
    whitespace (reference ``en_tn.py`` ``english_cleaners2`` shape)."""
    text = transliterate(text)
    text = text.lower()
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    return collapse_whitespace(text)
