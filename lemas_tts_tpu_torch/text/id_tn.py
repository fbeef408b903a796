"""Indonesian text normalization (reference ``text_norm/id_tn.py`` capability:
slang expansion, emoji stripping, number reading in Indonesian)."""

from __future__ import annotations

import re

# Common Indonesian texting slang → standard forms (reference ships a large
# map; this covers the high-frequency entries).
SLANG = {
    "gak": "tidak", "ga": "tidak", "nggak": "tidak", "ngga": "tidak",
    "gk": "tidak", "tdk": "tidak", "udah": "sudah", "udh": "sudah",
    "dah": "sudah", "blm": "belum", "belom": "belum", "bgt": "banget",
    "tp": "tapi", "dgn": "dengan", "dg": "dengan", "yg": "yang",
    "sy": "saya", "gw": "saya", "gue": "saya", "aku": "aku",
    "lu": "kamu", "lo": "kamu", "km": "kamu", "kmu": "kamu",
    "krn": "karena", "karna": "karena", "jg": "juga", "aja": "saja",
    "aj": "saja", "sm": "sama", "utk": "untuk", "dr": "dari",
    "pd": "pada", "dlm": "dalam", "hrs": "harus", "bs": "bisa",
    "bsa": "bisa", "org": "orang", "skrg": "sekarang", "td": "tadi",
    "gmn": "bagaimana", "gimana": "bagaimana", "knp": "kenapa",
    "emg": "memang", "emang": "memang", "bnr": "benar", "bener": "benar",
    "thx": "terima kasih", "makasih": "terima kasih", "mksh": "terima kasih",
}

_EMOJI = re.compile(
    "["
    "\U0001F300-\U0001FAFF"  # symbols, pictographs, extended
    "\U00002600-\U000027BF"  # misc symbols / dingbats
    "\U0001F1E6-\U0001F1FF"  # regional indicators
    "\U0000FE00-\U0000FE0F"  # variation selectors
    "\U0000200D"             # ZWJ
    "]+"
)

_ID_DIGITS = ["nol", "satu", "dua", "tiga", "empat", "lima", "enam",
              "tujuh", "delapan", "sembilan"]


def _id_int(n: int) -> str:
    """Indonesian cardinal reading (standard grammar: se- prefix forms)."""
    if n < 0:
        return "minus " + _id_int(-n)
    if n < 10:
        return _ID_DIGITS[n]
    if n < 12:
        return "sepuluh" if n == 10 else "sebelas"
    if n < 20:
        return _ID_DIGITS[n - 10] + " belas"
    if n < 100:
        head, rest = divmod(n, 10)
        return _ID_DIGITS[head] + " puluh" + (f" {_id_int(rest)}" if rest else "")
    if n < 200:
        return "seratus" + (f" {_id_int(n - 100)}" if n > 100 else "")
    if n < 1000:
        head, rest = divmod(n, 100)
        return _ID_DIGITS[head] + " ratus" + (f" {_id_int(rest)}" if rest else "")
    if n < 2000:
        return "seribu" + (f" {_id_int(n - 1000)}" if n > 1000 else "")
    if n < 10**6:
        head, rest = divmod(n, 1000)
        return _id_int(head) + " ribu" + (f" {_id_int(rest)}" if rest else "")
    if n < 10**9:
        head, rest = divmod(n, 10**6)
        return _id_int(head) + " juta" + (f" {_id_int(rest)}" if rest else "")
    head, rest = divmod(n, 10**9)
    return _id_int(head) + " miliar" + (f" {_id_int(rest)}" if rest else "")


def number_to_words_id(num: str) -> str:
    try:
        from num2words import num2words  # optional, like the reference

        return num2words(int(num) if "." not in num else float(num), lang="id")
    except Exception:
        pass
    if "." in num:
        int_part, frac = num.split(".", 1)
        frac_words = " ".join(_ID_DIGITS[int(c)] for c in frac if c.isdigit())
        return _id_int(int(int_part)) + " koma " + frac_words
    try:
        return _id_int(int(num))
    except ValueError:
        return num


def remove_emoji(text: str) -> str:
    return _EMOJI.sub(" ", text)


def expand_slang(text: str) -> str:
    return " ".join(SLANG.get(w.lower(), w) for w in text.split())


def indonesian_cleaners(text: str) -> str:
    """emoji strip → slang expand → number reading → whitespace collapse."""
    text = remove_emoji(text)
    text = expand_slang(text)
    text = re.sub(r"\b\d+(?:\.\d+)?\b",
                  lambda m: number_to_words_id(m.group(0)), text)
    return re.sub(r"\s+", " ", text).strip()
