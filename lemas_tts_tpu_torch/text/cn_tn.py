"""Chinese non-standard-word (NSW) normalization: digits, dates, money,
percentages, fractions, phone numbers → Chinese words.

Fresh implementation with the capability surface of the reference normalizer
(``lemas_tts/infer/text_norm/cn_tn.py:58-736``): the same NSW categories are
rewritten, but via a compact rule pipeline rather than the reference's
class-per-category design.
"""

from __future__ import annotations

import re

_DIGITS = "零一二三四五六七八九"
_UNITS_SMALL = ["", "十", "百", "千"]
_UNITS_BIG = ["", "万", "亿", "万亿"]


def digits_reading(s: str) -> str:
    """Digit-by-digit reading (phone numbers, IDs): '120' → 一二零."""
    return "".join(_DIGITS[int(c)] if c.isdigit() else c for c in s)


def _four_digits(s: str) -> str:
    """Read a ≤4-digit group, e.g. '2034' → 二千零三十四."""
    n = int(s)
    if n == 0:
        return ""
    out = []
    digits = [int(c) for c in str(n)]
    L = len(digits)
    zero_pending = False
    for i, d in enumerate(digits):
        unit = _UNITS_SMALL[L - 1 - i]
        if d == 0:
            if out:
                zero_pending = True
            continue
        if zero_pending:
            out.append("零")
            zero_pending = False
        out.append(_DIGITS[d] + unit)
    return "".join(out)


def _zero_padded(s: str) -> str:
    """Minute/second reading with the leading 零 for zero-padded values
    (8:05 → 八点零五分)."""
    r = num_to_chinese(s)
    if s.startswith("0") and len(s) > 1 and int(s) != 0:
        return "零" + r
    return r


def num_to_chinese(num: str) -> str:
    """Cardinal reading of an integer/decimal string (with optional sign)."""
    num = num.strip().replace(",", "")
    sign = ""
    if num.startswith("-"):
        sign, num = "负", num[1:]
    elif num.startswith("+"):
        sign, num = "正", num[1:]
    if "." in num:
        int_part, frac_part = num.split(".", 1)
        frac = "点" + digits_reading(frac_part)
    else:
        int_part, frac = num, ""
    int_part = int_part or "0"
    if len(int_part) > 16:
        return sign + digits_reading(int_part) + frac

    n = int(int_part)
    if n == 0:
        reading = "零"
    else:
        groups = []
        s = str(n)
        while s:
            groups.append(s[-4:])
            s = s[:-4]
        parts = []
        for gi in range(len(groups) - 1, -1, -1):
            g = groups[gi]
            r = _four_digits(g)
            if r:
                if parts and g[0] == "0":
                    # gap between groups: 20034 → 二万零三十四 (a lower
                    # group with leading zeros needs the linking 零)
                    parts.append("零")
                parts.append(r + _UNITS_BIG[gi])
            elif parts and any(int(c) for c in "".join(groups[:gi])):
                parts.append("零")
        reading = "".join(parts)
        # 一十X → 十X at the very front (10–19)
        if reading.startswith("一十"):
            reading = reading[1:]
        reading = re.sub(r"零+", "零", reading).rstrip("零") or "零"
    return sign + reading + frac


class NSWNormalizer:
    """Rewrite NSW patterns in Chinese text. ``normalize(text)`` is the
    entry point (same surface as the reference class, ``cn_tn.py:643-736``)."""

    def __init__(self, text: str = ""):
        self._text = text

    _RULES = None

    @classmethod
    def _rules(cls):
        if cls._RULES is None:
            N = r"\d+(?:[.]\d+)?"
            cls._RULES = [
                # date: 2024年3月15日 / 2024-03-15 / 2024/03/15
                (re.compile(r"(\d{4})[-/年](\d{1,2})[-/月](\d{1,2})[日号]?"),
                 lambda m: f"{digits_reading(m.group(1))}年"
                           f"{num_to_chinese(m.group(2))}月"
                           f"{num_to_chinese(m.group(3))}日"),
                # time: 8:30 / 08:30:15 (zero-padded minutes/seconds read
                # with a leading 零: 8:05 → 八点零五分)
                (re.compile(r"(\d{1,2}):(\d{2})(?::(\d{2}))?"),
                 lambda m: f"{num_to_chinese(m.group(1))}点"
                           f"{_zero_padded(m.group(2))}分"
                           + (f"{_zero_padded(m.group(3))}秒" if m.group(3) else "")),
                # money: ￥12.5 / 12.5元
                (re.compile(rf"[￥¥]({N})"), lambda m: num_to_chinese(m.group(1)) + "元"),
                (re.compile(rf"({N})元"), lambda m: num_to_chinese(m.group(1)) + "元"),
                # percent: 12.5% / 百分之
                (re.compile(rf"({N})%"), lambda m: "百分之" + num_to_chinese(m.group(1))),
                # fraction: 3/4 → 四分之三
                (re.compile(r"(\d+)/(\d+)"),
                 lambda m: num_to_chinese(m.group(2)) + "分之" + num_to_chinese(m.group(1))),
                # range: 3-5 → 三到五 (only between plain numbers)
                (re.compile(r"(\d+)[-~](\d+)"),
                 lambda m: num_to_chinese(m.group(1)) + "到" + num_to_chinese(m.group(2))),
                # phone-like long digit runs (≥8 digits): digit-by-digit
                (re.compile(r"\d{8,}"), lambda m: digits_reading(m.group(0))),
                # ordinal 第X
                (re.compile(r"第(\d+)"), lambda m: "第" + num_to_chinese(m.group(1))),
                # plain numbers
                (re.compile(rf"{N}"), lambda m: num_to_chinese(m.group(0))),
            ]
        return cls._RULES

    def normalize(self, text: str | None = None) -> str:
        out = self._text if text is None else text
        for pat, repl in self._rules():
            out = pat.sub(repl, out)
        return out
