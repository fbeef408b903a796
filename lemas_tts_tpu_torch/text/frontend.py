"""Multilingual text-normalization frontend: text → phone-token strings.

Host-side orchestrator with the behavior of the reference ``TextNorm``
(``lemas_tts/infer/frontend.py:18-251``): language id, per-language espeak-ng
IPA phonemization, the Chinese pipeline (NSW normalize → word segmentation →
TONE3 pinyin with sandhi → initial/final split), silence/pause ``#1..#4``
tokens derived from word-level timing gaps, number→words reading, and the
edit-prompt builders used by speech editing.

Output phone-string format (checkpoint contract, ``frontend.py:184-223``):
``(lang)`` tags + ``|``-separated phones with ``_`` word separators, e.g.
``(en)|h|ə|l|oʊ|_|w|ɜː|l|d|,``. Chinese words contribute
``(zh)|<initial>|<final-tone3>`` triples.

External G2P backends (espeak-ng via phonemizer, jieba, pypinyin, langid) are
used when installed; each degrades to a built-in pure-Python fallback
(char frontend / heuristic langid / lexicon+sandhi pinyin) so the frontend
works in hermetic environments.

Copy of ``lemas_tts_tpu/text/frontend.py`` with one intentional difference:
only an exact ``#1``-``#4`` is a pause token (``tokenizer.PAUSE_TOKENS``), on
every branch of ``text2phn`` and ``txt2pin_phns``. A ``#`` followed by
anything else is ordinary text, its own punctuation token; the JAX package
emits ``#:``, ``#a``, ``#5`` or ``#1x`` as one glued, out-of-vocab token.
"""

from __future__ import annotations

import re
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

from lemas_tts_tpu_torch.text import en_ipa, latin_ipa
from lemas_tts_tpu_torch.text import tokenizer as tok


def _builtin_g2p_supports(lang: str) -> bool:
    """Hermetic IPA G2P tier: en (lexicon+NRL rules, text/en_ipa.py) plus
    the regular orthographies es/it/id/de/pt/ru (ordered-rule transducers,
    text/latin_ipa.py)."""
    return en_ipa.supports(lang) or latin_ipa.supports(lang)


def _builtin_word_phones(word: str, lang: str):
    if en_ipa.supports(lang):
        return en_ipa.word_to_phones(word)
    if latin_ipa.supports(lang):
        return latin_ipa.word_to_phones(word, lang)
    return None


def _builtin_txt2phone(text: str, lang: str):
    if en_ipa.supports(lang):
        return en_ipa.txt2phone(text)
    if latin_ipa.supports(lang):
        return latin_ipa.txt2phone(text, lang)
    return None
from lemas_tts_tpu_torch.text.cn_tn import NSWNormalizer
from lemas_tts_tpu_torch.text.detect import detect_lang
from lemas_tts_tpu_torch.text.numwords import replace_numbers_with_words
from lemas_tts_tpu_torch.text.pinyin import (
    is_pinyin_syllable,
    split_syllable,
    word_to_phones,
)

# espeak voice per supported language (reference ``frontend.py:26``).
ESPEAK_LANGS: Dict[str, str] = {
    "en": "en-us", "it": "it", "es": "es", "pt": "pt-br", "fr": "fr-fr",
    "de": "de", "ru": "ru", "vi": "vi", "id": "id", "th": "th",
    "ja": "ja", "ko": "ko",
}

_PAUSE_TOKENS = tok.PAUSE_TOKENS
_HAN_RE = re.compile(r"[一-龥]+")
_LATIN_RE = re.compile(r"[a-zA-Z]")
# Any letter in any script (regex \p{L} equivalent via str.isalpha).
def _starts_with_letter(s: str) -> bool:
    return bool(s) and s[0].isalpha()


def _segment_chinese(text: str) -> List[str]:
    """Word segmentation: jieba when installed, else greedy per-char split
    keeping latin/digit runs together."""
    try:
        import jieba

        return list(jieba.cut(text))
    except Exception:
        return re.findall(r"[a-zA-Z0-9#]+|[一-龥]|[^\s]", text)


def _chars_to_pinyin(word: str, lexicon: Optional[Dict[str, List[str]]]) -> Optional[List[str]]:
    """Hanzi word → TONE3 pinyin list: pypinyin when installed, else the
    word lexicon (pinyin-lexicon-r.txt format), else None (caller falls back
    to char tokens)."""
    try:
        from pypinyin import Style, lazy_pinyin

        return [
            "".join(x)
            for x in lazy_pinyin(
                word, style=Style.TONE3, tone_sandhi=True, neutral_tone_with_five=True
            )
        ]
    except Exception:
        pass
    if lexicon:
        if word in lexicon:
            return list(lexicon[word])
        per_char = []
        for ch in word:
            if ch in lexicon:
                per_char.extend(lexicon[ch])
            else:
                return None
        return per_char
    return None


class TextNorm:
    """Text-normalization frontend (reference ``frontend.py:18-251``).

    Args:
      dtype: ``"phone"`` (espeak IPA + pinyin phones) or ``"char"``
        (normalized character stream — no espeak needed).
      lexicon_path: optional word→pinyin lexicon (pinyin-lexicon-r.txt format)
        used as the pypinyin fallback for Chinese.
      strict: when True, ``dtype="phone"`` raises if espeak-ng is missing;
        when False (default) it downgrades to the char frontend with a warning
        (the fallback the reference sketches at ``api.py:144-149``).
    """

    def __init__(
        self,
        dtype: str = "phone",
        lexicon_path: Optional[str] = None,
        strict: bool = False,
    ):
        assert dtype in ("phone", "char"), dtype
        if dtype == "phone" and not tok.available():
            if strict:
                raise RuntimeError(
                    "phone frontend requires espeak-ng (phonemizer); "
                    "pass dtype='char' or strict=False"
                )
            warnings.warn(
                "espeak-ng unavailable — en/es/it/id/de/pt/ru use the "
                "built-in IPA G2P (text/en_ipa.py, text/latin_ipa.py — "
                "approximations of the espeak contract); fr/vi/th/ja/ko "
                "fall back to the char frontend",
                stacklevel=2,
            )
        self.dtype = dtype
        self._tokenizers: Dict[str, tok.TextTokenizer] = {}  # lazy per-language
        self.cn_tn = NSWNormalizer()
        self.lexicon: Optional[Dict[str, List[str]]] = None
        if lexicon_path:
            self.lexicon = {}
            with open(lexicon_path, "r", encoding="utf-8") as f:
                for line in f:
                    fields = line.strip().split()
                    if fields:
                        self.lexicon[fields[0]] = fields[1:]

    # ------------------------------------------------------------- espeak
    def _tokenizer(self, lang: str) -> tok.TextTokenizer:
        lang = lang if lang in ESPEAK_LANGS else "en"
        t = self._tokenizers.get(lang)
        if t is None:
            t = tok.TextTokenizer(language=ESPEAK_LANGS[lang])
            self._tokenizers[lang] = t
        return t

    def detect_lang(self, text: str) -> str:
        return detect_lang(text)

    # ---------------------------------------------------- pause/sil tokens
    @staticmethod
    def sil_type(time_s: float) -> str:
        """Gap length (s) → pause token (reference ``frontend.py:40-50``)."""
        r = round(time_s)
        if r < 0.4:
            return ""
        if r < 0.8:
            return "#1"
        if r < 1.5:
            return "#2"
        if r < 3.0:
            return "#3"
        return "#4"

    def add_sil(
        self,
        sub_list: Sequence[dict],
        start_time: float,
        end_time: float,
        target_transcript: str,
        src_lang: str,
        tar_lang: str,
    ) -> List[List[str]]:
        """Word-timing list → [[lang, text], ...] segments with pause tokens,
        replacing words inside [start, end] by ``target_transcript``
        (reference ``frontend.py:71-98``; used by speech editing)."""
        txts: List[List[str]] = []
        words = [x["word"] for x in sub_list]
        sil = self.sil_type(sub_list[0]["start"])
        if sil:
            txts.append([src_lang, sil])
        if sub_list[0]["start"] < start_time:
            txts.append([src_lang, words[0]])
        elif target_transcript:
            # word 0 itself is inside the edit region: emit the replacement
            # here (the reference, frontend.py:78-88, starts its replacement
            # loop at i=1 and silently LOSES the edited text when the region
            # covers only the first word — not replicated)
            txts.append([tar_lang, target_transcript])
            target_transcript = ""
        for i in range(1, len(sub_list)):
            if sub_list[i]["start"] >= start_time and sub_list[i]["end"] <= end_time:
                txts.append([tar_lang, target_transcript])
                target_transcript = ""
            else:
                sil = self.sil_type(sub_list[i]["start"] - sub_list[i - 1]["end"])
                if sil:
                    txts.append([src_lang, sil])
                txts.append([src_lang, words[i]])
        return _merge_lang_runs(txts)

    def get_prompt(
        self,
        sub_list: Sequence[dict],
        start_time: float,
        end_time: float,
        src_lang: str,
    ) -> List[List[str]]:
        """Keep only words inside [start, end] with pause tokens
        (reference ``frontend.py:112-139``; NOTE the first word checks only
        ``start_time <= start`` — not its end — exactly like the reference
        ``:125``)."""
        txts: List[List[str]] = []
        words = [x["word"] for x in sub_list]
        if start_time <= sub_list[0]["start"]:
            sil = self.sil_type(sub_list[0]["start"])
            if sil:
                txts.append([src_lang, sil])
            txts.append([src_lang, words[0]])
        for i in range(1, len(sub_list)):
            if sub_list[i]["start"] >= start_time and sub_list[i]["end"] <= end_time:
                sil = self.sil_type(sub_list[i]["start"] - sub_list[i - 1]["end"])
                if sil:
                    txts.append([src_lang, sil])
                txts.append([src_lang, words[i]])
        return _merge_lang_runs(txts)

    # --------------------------------------------------------------- numbers
    def replace_numbers_with_words(self, sentence: str, lang: str = "en") -> str:
        return replace_numbers_with_words(sentence, lang=lang)

    # --------------------------------------------------------------- Chinese
    def txt2pinyin(self, text: str) -> Tuple[List[str], List[str]]:
        """Mixed Chinese text → (display tokens, phoneme tokens): NSW
        normalize, segment, TONE3 pinyin + sandhi, initial/final split;
        latin words pass through uppercased (reference ``frontend.py:142-182``).
        """
        txts: List[str] = []
        phonemes: List[str] = []
        for part in re.split(r"(#\d)", text):
            if part in _PAUSE_TOKENS:
                txts.append(part)
                phonemes.append(part)
                continue
            part = self.cn_tn.normalize(part.strip())
            for words in _segment_chinese(part):
                if words in tok._PAUSE_SYMBOL:
                    phonemes.append(tok._PAUSE_SYMBOL[words])
                    if txts:
                        txts[-1] += words
                    else:
                        txts.append(words)
                elif _HAN_RE.search(words):
                    py = _chars_to_pinyin(words, self.lexicon)
                    if py is None:  # no G2P available → char tokens
                        phonemes.extend(list(words))
                        txts.extend(list(words))
                        continue
                    phonemes.extend(word_to_phones(words, py))
                    txts.extend(list(words))
                elif _LATIN_RE.search(words) or re.search(r"#[1-4]", words):
                    phonemes.append(words.upper())
                    txts.append(words.upper())
        return txts, phonemes

    def txt2pin_phns(self, text: str) -> str:
        """Space-separated mixed pinyin/latin token string → final phone
        string with ``(zh)``/``(lang)`` tags (reference ``frontend.py:184-223``).

        Pinyin syllables split into initial+final phones; latin words go
        through espeak for their detected language; punctuation and pause
        tokens pass through (dropping a dangling word separator first).
        """
        # a '#' outside a pause token stands alone (the JAX package keeps
        # "#a" or "#1x" glued into one token here)
        text = " ".join(p if p in _PAUSE_TOKENS else p.replace("#", " # ")
                        for p in tok.split_pauses(text))
        text = re.sub(r"(?<! )([^\w\s])", r" \1", text)
        text = re.sub(r"\s+", " ", text).strip()

        res: List[str] = []
        for t in text.split(" "):
            if t == "":
                continue
            if is_pinyin_syllable(t):
                ini, fin = split_syllable(t.lower())
                res.append("(zh)")
                if ini:  # reference appends "" for zero-initial syllables
                    res.append(ini)  # (latent bug, SURVEY §2.5) — we skip it
                res.append(fin)
            elif t in _PAUSE_TOKENS or not _starts_with_letter(t):
                if res and res[-1] == "_":
                    res.pop()
                res.append(t)
                continue
            elif _HAN_RE.search(t):
                # raw hanzi reaching this point means no Chinese G2P was
                # available upstream (no pypinyin/lexicon) — keep char tokens
                # rather than feeding CJK to an espeak voice that can't read
                # it (espeak has no zh backend here, frontend.py langs map)
                if res and res[-1] == "_":
                    res.pop()
                res += ["(zh)"] + list(t)
            else:
                if res and res[-1] == "_":
                    res.pop()
                if self.dtype == "phone" and tok.available():
                    lang = detect_lang(t)
                    tk = self._tokenizer(lang)
                    ipa = tk.backend.phonemize(
                        [t], separator=tk.separator, strip=True, njobs=1
                    )
                    phns = ipa[0] if ipa[0][:1] == "(" else f"({lang})_" + ipa[0]
                    res += phns.replace("_", "|_|").split("|")
                else:
                    wl = detect_lang(t)
                    wp = (_builtin_word_phones(t, wl)
                          if self.dtype == "phone"
                          and _builtin_g2p_supports(wl) else None)
                    if wp:  # hermetic builtin IPA tier
                        res += [f"({wl})"] + wp
                    else:  # char fallback: the word as upper-case chars
                        res += [f"({wl})"] + list(t.upper())
            res.append("_")
        out = "|".join(res)
        return re.sub(r"(\|_)+", "|_", out)

    # ------------------------------------------------------------ main entry
    def text2phn(self, sentence: str, lang: Optional[str] = None) -> str:
        """Sentence → phone string (reference ``frontend.py:226-239``)."""
        if not lang:
            lang = detect_lang(sentence)
        if _HAN_RE.search(sentence):
            _, phones = self.txt2pinyin(sentence)
            return self.txt2pin_phns(" ".join(phones))
        norm = sentence
        if self.dtype == "phone" and tok.available():
            phones = tok.txt2phone(
                self._tokenizer(lang), norm.strip().replace(".", ",").replace("。", ",")
            )
            return f"({lang})|" + phones if phones[:1] != "(" else phones
        if self.dtype == "phone" and _builtin_g2p_supports(lang):
            # hermetic fallback tier: built-in IPA G2P (en via lexicon+NRL
            # rules, es/it/id via ordered-rule transduction). espeak reads
            # digits itself; the builtin needs them as words first —
            # expanded per non-pause segment so "#2" markers survive intact.
            norm = norm.strip().replace(".", ",").replace("。", ",")
            norm = "".join(
                part if part in _PAUSE_TOKENS
                else replace_numbers_with_words(part, lang=lang)
                for part in tok.split_pauses(norm))
            phones = _builtin_txt2phone(norm, lang)
            if phones:
                return f"({lang})|" + phones
        # char frontend: normalized chars with a lang tag; ``#1``-``#4``
        # pause markers stay single tokens (they are vocab entries, as on the
        # espeak path's txt2phone); any other text, '#' included, splits
        # into chars
        _, norm = self.text2norm(sentence, lang)
        parts: List[str] = []
        for seg in tok.split_pauses(norm):
            parts += [seg] if seg in _PAUSE_TOKENS else list(seg)
        return "|".join([f"({lang})"] + parts)

    def text2norm(self, sentence: str, lang: Optional[str] = None) -> Tuple[str, str]:
        """Sentence → (lang, normalized text) — the char frontend
        (reference ``frontend.py:242-251``)."""
        if not lang:
            lang = detect_lang(sentence)
        if _HAN_RE.search(sentence):
            _, phones = self.txt2pinyin(sentence)
            return lang, " ".join(phones)
        # collapse whitespace runs (incl. newlines/tabs) so the char frontend
        # never emits raw control characters as tokens
        return lang, re.sub(r"\s+", " ", sentence).strip()


def _merge_lang_runs(txts: List[List[str]]) -> List[List[str]]:
    """Merge consecutive same-language segments (reference ``frontend.py:90-98``)."""
    if not txts:
        return []
    out = [txts[0]]
    for lang, text in txts[1:]:
        if text == "":
            continue
        if lang != out[-1][0]:
            out.append([lang, ""])
        out[-1][-1] += " " + text
    return out
