"""Grapheme→pinyin utility (reference ``text_norm/gp2py.py`` capability):
mixed Chinese/latin text → (TONE3 pinyin string, normalized text), with
word segmentation and tone fixes. Uses jieba/pypinyin when installed and the
framework's lexicon/sandhi fallbacks otherwise."""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from lemas_tts_tpu_torch.text.cn_tn import NSWNormalizer
from lemas_tts_tpu_torch.text.frontend import _chars_to_pinyin, _segment_chinese
from lemas_tts_tpu_torch.text.pinyin import apply_tone_sandhi

_HAN = re.compile(r"[一-龥]")


class GP2PY:
    """Grapheme-to-pinyin converter.

    ``gp2py("你好 world")`` → ``("ni3 hao3 WORLD", "你好 WORLD")``.
    """

    def __init__(self, lexicon_path: Optional[str] = None):
        self.cn_tn = NSWNormalizer()
        self.lexicon = None
        if lexicon_path:
            self.lexicon = {}
            with open(lexicon_path, "r", encoding="utf-8") as f:
                for line in f:
                    fields = line.strip().split()
                    if fields:
                        self.lexicon[fields[0]] = fields[1:]

    def gp2py(self, text: str) -> Tuple[str, str]:
        text = self.cn_tn.normalize(text.strip())
        pinyin: List[str] = []
        display: List[str] = []
        for word in _segment_chinese(text):
            if not word.strip():
                continue
            if _HAN.search(word):
                py = _chars_to_pinyin(word, self.lexicon)
                if py is None:  # no G2P backend → keep chars
                    pinyin.extend(list(word))
                else:
                    pinyin.extend(apply_tone_sandhi(word, py))
                display.extend(list(word))
            elif re.search(r"[a-zA-Z]", word):
                pinyin.append(word.upper())
                display.append(word.upper())
            else:
                pinyin.append(word)
                display.append(word)
        return " ".join(pinyin), " ".join(display)
