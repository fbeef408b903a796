"""Pinyin syllable handling: algorithmic initial/final split + tone sandhi.

Replaces the reference's 419-line static syllable table
(``text_norm/symbols.py``) with the standard algorithmic decomposition
(longest-initial match), and implements the tone-sandhi rules of
``text_norm/txt2pinyin.py:31-137`` (3-3 rule, 不/一 tone changes, erhua)
without the reference's ``er5`` NameError bug (copy of
``lemas_tts_tpu/text/pinyin.py``).

Syllables use TONE3 notation: e.g. ``zhong1``, ``lv4`` (v = ü), neutral
tone → ``5`` when ``neutral_tone_with_five``.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

# Longest-match-first initials (strict=False semantics: y/w count as initials).
_INITIALS = (
    "zh", "ch", "sh",
    "b", "p", "m", "f", "d", "t", "n", "l",
    "g", "k", "h", "j", "q", "x", "r", "z", "c", "s", "y", "w",
)

_TONE_RE = re.compile(r"^([a-zv]+)([1-5]?)$")


def split_syllable(syllable: str, neutral_tone_with_five: bool = True) -> Tuple[str, str]:
    """``"zhong1"`` → ``("zh", "ong1")``; zero-initial syllables give ``("", final)``."""
    m = _TONE_RE.match(syllable.lower())
    if not m:
        return "", syllable
    base, tone = m.group(1), m.group(2)
    if not tone and neutral_tone_with_five:
        tone = "5"
    initial = ""
    for ini in _INITIALS:
        if base.startswith(ini) and len(base) > len(ini):
            initial = ini
            break
    final = base[len(initial):] + tone
    return initial, final


# All valid pinyin final bases (strict=False: y/w are initials, ü written v).
_FINALS = frozenset(
    "a o e i u v ai ei ui ao ou iu ie ue ve er an en in un vn ang eng ing "
    "ong ia iao ian iang iong ua uo uai uan uang ueng uen io ei n ng m".split()
)


def is_pinyin_syllable(token: str) -> bool:
    """True for a lowercase TONE3 pinyin syllable (e.g. ``ni3``, ``lv4``).

    Replaces the reference's lexicon-membership test
    (``frontend.py:191 ``txt in self.cmn_dict``) with the algorithmic check:
    tone digit present and the base decomposes into valid initial+final.
    """
    m = _TONE_RE.match(token)
    if not m or token != token.lower() or not m.group(2):
        return False
    base = m.group(1)
    if base in _FINALS:
        return True
    for ini in _INITIALS:
        if base.startswith(ini) and base[len(ini):] in _FINALS:
            return True
    return False


def to_initials(syllable: str) -> str:
    return split_syllable(syllable)[0]


def to_finals_tone3(syllable: str, neutral_tone_with_five: bool = True) -> str:
    return split_syllable(syllable, neutral_tone_with_five)[1]


def _tone_of(syllable: str) -> str:
    return syllable[-1] if syllable and syllable[-1].isdigit() else ""


def _with_tone(syllable: str, tone: str) -> str:
    base = syllable[:-1] if _tone_of(syllable) else syllable
    return base + tone


def apply_tone_sandhi(chars: str, pinyin: Sequence[str]) -> List[str]:
    """Word-level Mandarin tone sandhi (reference ``txt2pinyin.py:99-137``):

    - 不 is tone 4, but tone 2 before another tone-4 syllable;
    - 一 is tone 2 before tone 4, tone 4 before tones 1/2/3 (kept as-is when
      final in the word, e.g. ordinals);
    - consecutive third tones: the former becomes tone 2 (left-to-right).
    """
    py = list(pinyin)
    n = min(len(chars), len(py))
    for i in range(n):
        nxt = _tone_of(py[i + 1]) if i + 1 < n else ""
        if chars[i] == "不":
            # only the 2-before-4 rule; never retone otherwise (a neutral
            # bu5 from pypinyin, e.g. 对不起, must stay neutral — reference
            # change_tone_in_bu_or_yi :134-136 likewise only sets bu2)
            if nxt == "4":
                py[i] = _with_tone(py[i], "2")
        elif chars[i] == "一" and i + 1 < n:
            if nxt == "4":
                py[i] = _with_tone(py[i], "2")
            elif nxt in ("1", "2", "3"):
                py[i] = _with_tone(py[i], "4")
    for i in range(n - 1):
        if _tone_of(py[i]) == "3" and _tone_of(py[i + 1]) == "3":
            py[i] = _with_tone(py[i], "2")
    return py


def word_to_phones(chars: str, pinyin: Sequence[str]) -> List[str]:
    """Word (chars + TONE3 pinyin) → phone list with sandhi and erhua merge.

    Erhua: a trailing 儿 read as bare "er" merges into the preceding final as
    the neutral-tone phone ``er5`` (fixing the reference's NameError path,
    ``txt2pinyin.py:56``).
    """
    py = apply_tone_sandhi(chars, pinyin)
    phones: List[str] = []
    i = 0
    n = min(len(chars), len(py))
    while i < n:
        is_erhua = (
            i + 1 < n
            and chars[i + 1] == "儿"
            and py[i + 1][:-1] in ("er", "r")
            and i + 1 == n - 1
        )
        ini, fin = split_syllable(py[i])
        if ini:
            phones.append(ini)
        phones.append(fin)
        if is_erhua:
            phones.append("er5")
            i += 2
        else:
            i += 1
    return phones
