"""Number → words: ``num2words`` when installed (full 10-language coverage,
as the reference uses at ``frontend.py:100-109``), with a built-in English
converter + digit-reading fallback for other languages."""

from __future__ import annotations

import re

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
         "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10**9, "billion"), (10**6, "million"), (1000, "thousand"), (100, "hundred")]

_DIGIT_WORDS = {
    "en": _ONES[:10],
    "es": ["cero", "uno", "dos", "tres", "cuatro", "cinco", "seis", "siete", "ocho", "nueve"],
    "pt": ["zero", "um", "dois", "três", "quatro", "cinco", "seis", "sete", "oito", "nove"],
    "fr": ["zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept", "huit", "neuf"],
    "de": ["null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben", "acht", "neun"],
    "it": ["zero", "uno", "due", "tre", "quattro", "cinque", "sei", "sette", "otto", "nove"],
    "ru": ["ноль", "один", "два", "три", "четыре", "пять", "шесть", "семь", "восемь", "девять"],
    "id": ["nol", "satu", "dua", "tiga", "empat", "lima", "enam", "tujuh", "delapan", "sembilan"],
    "vi": ["không", "một", "hai", "ba", "bốn", "năm", "sáu", "bảy", "tám", "chín"],
    "th": ["ศูนย์", "หนึ่ง", "สอง", "สาม", "สี่", "ห้า", "หก", "เจ็ด", "แปด", "เก้า"],
}


def _en_int(n: int) -> str:
    if n < 0:
        return "minus " + _en_int(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t] + ("-" + _ONES[r] if r else "")
    for value, name in _SCALE:
        if n >= value:
            head, rest = divmod(n, value)
            out = _en_int(head) + " " + name
            if rest:
                out += " " + _en_int(rest)
            return out
    return str(n)


def number_to_words(num: str, lang: str = "en") -> str:
    """Convert a numeric string to words in ``lang``."""
    try:
        from num2words import num2words  # optional dep

        val = float(num) if "." in num else int(num)
        return num2words(val, lang=lang)
    except Exception:
        pass

    if "." in num:
        int_part, frac = num.split(".", 1)
        point = {"en": "point", "es": "coma", "pt": "vírgula", "fr": "virgule",
                 "de": "Komma", "it": "virgola"}.get(lang, "point")
        digits = _DIGIT_WORDS.get(lang, _DIGIT_WORDS["en"])
        frac_words = " ".join(digits[int(c)] for c in frac if c.isdigit())
        return number_to_words(int_part, lang) + f" {point} " + frac_words

    try:
        n = int(num)
    except ValueError:
        return num
    if lang == "en" or lang not in _DIGIT_WORDS:
        return _en_int(n)
    if 0 <= n <= 9:
        return _DIGIT_WORDS[lang][n]
    if lang in _DIGIT_WORDS and n < 0:
        return "- " + number_to_words(str(-n), lang)
    # digit-by-digit fallback for other languages
    digits = _DIGIT_WORDS[lang]
    return " ".join(digits[int(c)] for c in str(n) if c.isdigit())


def replace_numbers_with_words(sentence: str, lang: str = "en") -> str:
    """Space-pad digits then replace each number with its reading
    (reference ``frontend.py:100-109`` semantics)."""
    sentence = re.sub(r"(\d+(?:\.\d+)?)", r" \1 ", sentence)
    return re.sub(
        r"\b\d+(?:\.\d+)?\b", lambda m: number_to_words(m.group(0), lang), sentence
    )
