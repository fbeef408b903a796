"""Language identification: ``langid`` when installed, else a built-in
heuristic (script ranges + stop-word profiles) over the same 14-language set
the reference configures (``frontend.py:25``)."""

from __future__ import annotations

import re

LANGS = ["es", "pt", "zh", "en", "de", "fr", "it", "ru", "vi", "id", "th", "ja", "ko", "ar"]

try:  # optional dependency, same as reference
    import langid as _langid

    _langid.set_languages(LANGS)

    def detect_lang(text: str) -> str:
        return _langid.classify(text)[0]

except Exception:  # built-in heuristic fallback

    _STOPWORDS = {
        "en": {"the", "and", "is", "of", "to", "you", "that", "it", "for", "was",
               "with", "are", "this", "have", "not", "i", "he", "she", "they"},
        "es": {"el", "la", "los", "las", "de", "que", "y", "es", "en", "un",
               "una", "por", "con", "no", "para", "su", "al", "como", "está"},
        "pt": {"o", "a", "os", "as", "de", "que", "e", "é", "em", "um", "uma",
               "para", "com", "não", "do", "da", "no", "na", "você", "mais"},
        "fr": {"le", "la", "les", "de", "et", "est", "en", "un", "une", "que",
               "pour", "dans", "ce", "il", "elle", "au", "du", "pas", "je", "vous"},
        "de": {"der", "die", "das", "und", "ist", "in", "ein", "eine", "zu",
               "den", "nicht", "mit", "sich", "auf", "für", "ich", "sie", "es"},
        "it": {"il", "la", "le", "di", "che", "e", "è", "in", "un", "una",
               "per", "con", "non", "sono", "del", "della", "si", "io", "mi"},
        "id": {"yang", "dan", "di", "itu", "dengan", "untuk", "tidak", "ini",
               "dari", "dalam", "akan", "pada", "juga", "saya", "ke", "karena",
               "ada", "mereka", "bisa", "kita"},
        "vi": {"và", "của", "là", "có", "không", "được", "trong", "đã", "cho",
               "người", "những", "với", "các", "một", "này", "tôi", "bạn"},
    }

    def detect_lang(text: str) -> str:
        t = text.strip()
        if re.search(r"[一-鿿]", t):
            # kana present → ja, else zh
            return "ja" if re.search(r"[぀-ヿ]", t) else "zh"
        if re.search(r"[぀-ヿ]", t):
            return "ja"
        if re.search(r"[가-힯]", t):
            return "ko"
        if re.search(r"[฀-๿]", t):
            return "th"
        if re.search(r"[Ѐ-ӿ]", t):
            return "ru"
        if re.search(r"[؀-ۿ]", t):
            return "ar"
        # Vietnamese diacritics are distinctive
        if re.search(r"[ăâđêôơưạảấầẩẫậắằẳẵặẹẻẽếềểễệịỉĩọỏốồổỗộớờởỡợụủứừửữựỳỵỷỹ]", t.lower()):
            return "vi"
        words = re.findall(r"[a-zà-ÿ']+", t.lower())
        if not words:
            return "en"
        best, best_score = "en", -1.0
        for lang, sw in _STOPWORDS.items():
            score = sum(1 for w in words if w in sw) / len(words)
            if score > best_score:
                best, best_score = lang, score
        return best
