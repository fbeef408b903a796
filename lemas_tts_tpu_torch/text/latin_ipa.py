"""Built-in grapheme→IPA fallback for regular-orthography languages.

Companion to ``text/en_ipa.py`` (copy of ``lemas_tts_tpu/text/latin_ipa.py``): the real
checkpoint text contract is espeak-ng IPA (reference
``lemas_tts/infer/text_norm/tokenizer.py:26-74``); hermetic environments
previously degraded every non-English espeak language to CHAR tokens.
English needed a lexicon + NRL rules; **es, it, id, de, pt(-br) and ru
have (near-)deterministic orthographies**, so compact ordered-rule
transducers get hermetic output close to the espeak contract with no
lexicon at all. (fr/vi/th/ja/ko orthographies are genuinely irregular or
non-alphabetic and stay on the char fallback.)

Approximations (documented, deliberate — this is a fallback tier, not an
espeak clone): no stress marks (matching our
``EspeakBackend(with_stress=False)``); Spanish uses distinción (c/z → θ,
the es voice's dialect); Italian/German double letters collapse to single
phones; German models ich/ach-Laut, initial sp/st → ʃ, final devoicing,
-ig → ɪç, final -e/-er reduction; Portuguese is BR-flavored (d/t
palatalization before i, final o→u / e→i) with nasal vowels denasalized;
Russian ignores stress-dependent vowel reduction and palatal assimilation.
The separator grammar matches ``text/tokenizer.py``: phones ``|``-joined,
``_`` between words, punctuation as its own token, ``#1``-``#4`` pause
markers preserved.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

_VOWELS = "aeiou"

# accent/diacritic folding applied BEFORE the rules (ü survives for the
# Spanish gü rule; ñ is consumed by its own rule)
_FOLD = str.maketrans({
    "á": "a", "é": "e", "í": "i", "ó": "o", "ú": "u",
    "à": "a", "è": "e", "ì": "i", "ò": "o", "ù": "u",
    "â": "a", "ê": "e", "î": "i", "ô": "o", "û": "u",
})

# Ordered rules: (compiled regex matched AT the cursor, space-joined
# phones). First match wins; the cursor advances by the match length —
# contexts go in lookaheads so they are not consumed. Single letters with
# position-dependent outcomes (Spanish r/y, Italian s) are handled in the
# per-language hook below.
def _rules(pairs: List[Tuple[str, str]]):
    return [(re.compile(p), out) for p, out in pairs]


_ES_RULES = _rules([
    ("ch", "tʃ"),
    ("ll", "ʎ"),
    ("qu(?=[ei])", "k"),
    ("qu", "k w"),
    ("gü(?=[ei])", "ɡ w"),
    ("gu(?=[ei])", "ɡ"),
    ("g(?=[ei])", "x"),
    ("c(?=[ei])", "θ"),
    ("ñ", "ɲ"),
    ("ü", "u"),
    ("a", "a"), ("e", "e"), ("i", "i"), ("o", "o"), ("u", "u"),
    ("b", "b"), ("v", "b"), ("c", "k"), ("d", "d"), ("f", "f"),
    ("g", "ɡ"), ("h", ""), ("j", "x"), ("k", "k"), ("l", "l"),
    ("m", "m"), ("n", "n"), ("p", "p"), ("q", "k"), ("s", "s"),
    ("t", "t"), ("w", "w"), ("x", "k s"), ("z", "θ"),
])

_IT_RULES = _rules([
    # doubles first: orthographic gemination collapses to the single phone
    # WITH its softening context, and is seen before the intervocalic-s
    # voicing hook can misread e.g. "cassa" as a voiced single s
    ("cch", "k"), ("cci(?=[aeou])", "tʃ"), ("cc(?=[ei])", "tʃ"), ("cc", "k"),
    ("ggh", "ɡ"), ("ggi(?=[aeou])", "dʒ"), ("gg(?=[ei])", "dʒ"), ("gg", "ɡ"),
    ("zz", "t s"), ("ss", "s"), ("tt", "t"), ("nn", "n"), ("mm", "m"),
    ("ll", "l"), ("pp", "p"), ("ff", "f"), ("rr", "r"), ("bb", "b"),
    ("dd", "d"),
    ("sci(?=[aeou])", "ʃ"),
    ("sc(?=[ei])", "ʃ"),
    ("ch", "k"),
    ("gh", "ɡ"),
    ("gli(?=[aeou])", "ʎ"),
    ("gli", "ʎ i"),
    ("gn", "ɲ"),
    ("ci(?=[aeou])", "tʃ"),
    ("c(?=[ei])", "tʃ"),
    ("gi(?=[aeou])", "dʒ"),
    ("g(?=[ei])", "dʒ"),
    ("qu", "k w"),
    ("a", "a"), ("e", "e"), ("i", "i"), ("o", "o"), ("u", "u"),
    ("b", "b"), ("c", "k"), ("d", "d"), ("f", "f"), ("g", "ɡ"),
    ("h", ""), ("j", "j"), ("k", "k"), ("l", "l"), ("m", "m"),
    ("n", "n"), ("p", "p"), ("q", "k"), ("r", "r"), ("s", "s"),
    ("t", "t"), ("v", "v"), ("w", "w"), ("x", "k s"), ("y", "i"),
    ("z", "t s"),
])

_DE_RULES = _rules([
    # doubles mark a short preceding vowel, not gemination — collapse them
    # before the s-voicing hook could misread "wasser" as intervocalic s
    ("ss", "s"), ("tt", "t"), ("nn", "n"), ("mm", "m"), ("ll", "l"),
    ("pp", "p"), ("ff", "f"), ("rr", "ʁ"), ("bb", "b"), ("dd", "d"),
    ("gg", "ɡ"), ("kk", "k"),
    ("tsch", "tʃ"),
    ("sch", "ʃ"),
    ("ch(?=s)", "k"),          # sechs, wachsen
    ("ck", "k"),
    ("ph", "f"),
    ("th", "t"),
    ("qu", "k v"),
    ("ei", "aɪ"), ("ai", "aɪ"),
    ("ieh", "iː"), ("ie", "iː"),
    ("eu", "ɔʏ"), ("äu", "ɔʏ"),
    ("au", "aʊ"),
    ("aa", "aː"), ("ee", "eː"), ("oo", "oː"),
    ("ah", "aː"), ("eh", "eː"), ("ih", "iː"), ("oh", "oː"), ("uh", "uː"),
    ("äh", "ɛː"), ("öh", "øː"), ("üh", "yː"),
    ("ä", "ɛ"), ("ö", "ø"), ("ü", "y"), ("ß", "s"),
    ("tz", "ts"), ("z", "ts"),
    ("w", "v"), ("v", "f"),
    ("ng", "ŋ"),
    ("a", "a"), ("e", "ɛ"), ("i", "ɪ"), ("o", "ɔ"), ("u", "ʊ"),
    ("y", "y"),
    ("b", "b"), ("c", "k"), ("d", "d"), ("f", "f"), ("g", "ɡ"),
    ("h", "h"), ("j", "j"), ("k", "k"), ("l", "l"), ("m", "m"),
    ("n", "n"), ("p", "p"), ("q", "k"), ("r", "ʁ"), ("s", "s"),
    ("t", "t"), ("x", "k s"),
])

# Cyrillic — not Latin, but the same regular-orthography story (palatal
# assimilation and unstressed-vowel reduction are stress-dependent and
# intentionally NOT modelled; still far closer to the espeak contract
# than out-of-vocab Cyrillic char tokens)
_RU_RULES = _rules([
    ("а", "a"), ("б", "b"), ("в", "v"), ("г", "ɡ"), ("д", "d"),
    ("ё", "j o"), ("ж", "ʒ"), ("з", "z"), ("и", "i"), ("й", "j"),
    ("к", "k"), ("л", "l"), ("м", "m"), ("н", "n"), ("о", "o"),
    ("п", "p"), ("р", "r"), ("с", "s"), ("т", "t"), ("у", "u"),
    ("ф", "f"), ("х", "x"), ("ц", "ts"), ("ч", "tʃ"), ("ш", "ʃ"),
    ("щ", "ʃ"), ("ъ", ""), ("ы", "ɨ"), ("ь", ""), ("э", "e"),
    ("ю", "j u"), ("я", "j a"), ("е", "e"),
])

# Brazilian Portuguese (the pt voice here is pt-br, frontend.ESPEAK_LANGS).
# Nasal vowels are emitted denasalized and vowel reduction beyond final
# o→u / e→i is not modelled — documented approximation.
_PT_RULES = _rules([
    ("nh", "ɲ"),
    ("lh", "ʎ"),
    ("ch", "ʃ"),
    ("ss", "s"),
    ("qu(?=[ei])", "k"),
    ("qu", "k w"),
    ("gu(?=[ei])", "ɡ"),
    ("g(?=[ei])", "ʒ"),
    ("c(?=[ei])", "s"),
    ("ç", "s"),
    ("j", "ʒ"),
    ("x", "ʃ"),
    ("d(?=i)", "dʒ"),   # BR palatalization: dia → dʒia
    ("t(?=i)", "tʃ"),   # BR: tio → tʃiu
    # (acute/circumflex accents are folded to plain vowels before the
    # rules run — _FOLD; only the nasal tildes survive to here)
    ("ã", "a"), ("õ", "o"),
    ("a", "a"), ("e", "e"), ("i", "i"), ("o", "o"), ("u", "u"),
    ("b", "b"), ("c", "k"), ("d", "d"), ("f", "f"), ("g", "ɡ"),
    ("h", ""), ("k", "k"), ("l", "l"), ("m", "m"), ("n", "n"),
    ("p", "p"), ("q", "k"), ("s", "s"), ("t", "t"), ("v", "v"),
    ("w", "w"), ("y", "i"), ("z", "z"),
])

_ID_RULES = _rules([
    ("ny", "ɲ"),
    ("ng", "ŋ"),
    ("sy", "ʃ"),
    ("kh", "x"),
    ("c", "tʃ"),
    ("j", "dʒ"),
    ("y", "j"),
    ("e", "ə"),
    ("a", "a"), ("i", "i"), ("o", "o"), ("u", "u"),
    ("b", "b"), ("d", "d"), ("f", "f"), ("g", "ɡ"), ("h", "h"),
    ("k", "k"), ("l", "l"), ("m", "m"), ("n", "n"), ("p", "p"),
    ("q", "k"), ("r", "r"), ("s", "s"), ("t", "t"), ("v", "f"),
    ("w", "w"), ("x", "k s"), ("z", "z"),
])


def _es_hook(word: str, pos: int) -> "Tuple[str, int] | None":
    ch = word[pos]
    if ch == "r":
        if word.startswith("rr", pos):  # digraph trill (hook runs before
            return "r", 2               # the rule table, so handle it here)
        # trill word-initially / after n, l, s; tap otherwise
        return ("r" if pos == 0 or word[pos - 1] in "nls" else "ɾ"), 1
    if ch == "y":  # vocalic word-finally and as the standalone word "y"
        return ("i" if pos == len(word) - 1 else "ʝ"), 1
    return None


def _it_hook(word: str, pos: int) -> "Tuple[str, int] | None":
    if word[pos] == "s" and 0 < pos < len(word) - 1 \
            and word[pos - 1] in _VOWELS and word[pos + 1] in _VOWELS:
        return "z", 1  # intervocalic s voices (casa → kaza)
    return None


_DE_BACK = "aouʊ"


def _de_hook(word: str, pos: int) -> "Tuple[str, int] | None":
    ch = word[pos]
    n = len(word)
    # ich-/ach-Laut allophony ("chs"→ks and s|ch are consumed by the rule
    # table before the cursor ever lands on this bare "ch")
    if word.startswith("ch", pos) and not word.startswith("chs", pos):
        prev = word[pos - 1] if pos > 0 else ""
        return ("x" if prev in _DE_BACK else "ç"), 2
    if pos == 0 and (word.startswith("sp", pos) or word.startswith("st", pos)):
        return ("ʃ " + ("p" if word[1] == "p" else "t")), 2
    if ch == "s" and pos + 1 < n and word[pos + 1] in _VOWELS \
            and (pos == 0 or word[pos - 1] in _VOWELS):
        return "z", 1  # voiced s before a vowel (Sonne, lesen)
    if pos == n - 2 and word.endswith("ig"):
        return "ɪ ç", 2  # -ig → ɪç (König)
    if pos == n - 1:
        if ch in "bdg":  # final devoicing
            return {"b": "p", "d": "t", "g": "k"}[ch], 1
        if ch == "e":
            return "ə", 1  # schwa (bitte)
    if pos == n - 2 and word.endswith("er"):
        return "ɐ", 2  # vocalized -er (Wasser)
    return None


def _pt_hook(word: str, pos: int) -> "Tuple[str, int] | None":
    ch = word[pos]
    n = len(word)
    if word.startswith("rr", pos):
        return "ʁ", 2
    if ch == "r":
        return ("ʁ" if pos == 0 else "ɾ"), 1
    if ch == "s" and 0 < pos < n - 1 and word[pos - 1] in _VOWELS \
            and word[pos + 1] in _VOWELS:
        return "z", 1  # intervocalic s (casa → kaza)
    if pos == n - 2 and word.endswith("te"):
        return "tʃ i", 2  # reduced final -te palatalizes (gente → ʒẽtʃi)
    if pos == n - 2 and word.endswith("de"):
        return "dʒ i", 2  # cidade → sidadʒi
    if pos == n - 1:
        if ch == "o":
            return "u", 1  # final-vowel reduction (BR)
        if ch == "e":
            return "i", 1
    return None


_LANGS: Dict[str, tuple] = {
    # lang → (rules, pre-transduction hook)
    "es": (_ES_RULES, _es_hook),
    "it": (_IT_RULES, _it_hook),
    "id": (_ID_RULES, None),
    "de": (_DE_RULES, _de_hook),
    "ru": (_RU_RULES, None),
    "pt": (_PT_RULES, _pt_hook),
}


def supports(lang: str) -> bool:
    """Languages this builtin G2P covers (en lives in ``text/en_ipa.py``)."""
    return lang in _LANGS


def word_to_phones(word: str, lang: str) -> List[str]:
    """One lowercase word → IPA phone list by ordered-rule transduction."""
    rules, hook = _LANGS[lang]
    w = word.lower().translate(_FOLD)
    phones: List[str] = []
    pos = 0
    while pos < len(w):
        if hook is not None:
            hit = hook(w, pos)
            if hit is not None:
                out, adv = hit
                if out:
                    phones.extend(out.split())
                pos += adv
                continue
        for rx, out in rules:
            m = rx.match(w, pos)
            if m:
                if out:
                    phones.extend(out.split())
                pos += len(m.group(0))
                break
        else:  # unknown character (apostrophe, foreign letter): skip
            pos += 1
    return phones


# apostrophes join elided words (it "l'acqua" → one word /lakkwa/, the
# transducer skips the apostrophe itself)
_WORD_RE = re.compile(r"[^\W\d_]+(?:['’][^\W\d_]+)*|[0-9]+|[^\w\s]",
                      re.UNICODE)


def phonemize_tokens_with(word_fn, text: str,
                          word_re: "re.Pattern" = _WORD_RE) -> List[str]:
    """Generic text → token list in the espeak-wrapper grammar
    (``tokenizer.TextTokenizer.to_list``): per-word phones via ``word_fn``,
    ``_`` between words, punctuation as its own token, digit runs (expand
    numbers upstream via ``numwords``) as per-character tokens. Shared by
    ``en_ipa`` and this module so the separator contract lives once.

    A word ``word_fn`` can't phonemize at all (foreign script for the
    language's rules) falls back to per-character tokens — degraded like
    the char frontend, never silently dropped from the audio."""
    fields: List[str] = []
    for part in word_re.findall(text):
        if part[0].isalpha() or part[0] in "'’":
            ph = word_fn(part) or list(part.upper())
            if fields and fields[-1] != "_":
                fields.append("_")  # word separator (espeak order: phones,
                # punct, THEN the next word's separator)
            fields.extend(ph)
        elif part[0].isdigit():
            if fields and fields[-1] != "_":
                fields.append("_")
            fields.extend(list(part))
        elif part == "-":
            pass  # hyphens read as word joins
        else:
            fields.append(part)
    while fields and fields[0] == "_":
        fields.pop(0)
    while fields and fields[-1] == "_":
        fields.pop()
    return fields


def phonemize_tokens(text: str, lang: str) -> List[str]:
    """Text → token list in the espeak-wrapper grammar for ``lang``."""
    return phonemize_tokens_with(lambda w: word_to_phones(w, lang), text)


def txt2phone(text: str, lang: str) -> str:
    """Builtin analogue of ``tokenizer.txt2phone``: ``|``-joined phones
    preserving ``#1``-``#4`` pause markers, CJK punctuation mapped to ASCII."""
    from lemas_tts_tpu_torch.text.tokenizer import PAUSE_TOKENS, _PAUSE_SYMBOL, split_pauses

    text = re.sub("|".join(_PAUSE_SYMBOL),
                  lambda m: _PAUSE_SYMBOL[m.group(0)], text)
    phones: List[str] = []
    for part in split_pauses(text):
        if part in PAUSE_TOKENS:
            phones.append(part)
        elif part:
            phones += phonemize_tokens(part, lang)
    return "|".join(phones)
