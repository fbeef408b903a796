"""Vocabulary / tokenizer utilities (copy of ``lemas_tts_tpu/utils/vocab.py``).

Checkpoint-contract semantics (reference ``model/utils.py:81-128``):
 - vocab.txt: one token per line; line index = id; unknown token -> id 0
   (space is id 0 by convention); batch padding value is -1 (the model later
   shifts ids by +1 so -1 -> 0 = filler).
 - "byte" tokenizer: raw UTF-8 bytes (ByT5-style), vocab size 256.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

PAD_ID = -1
UNK_ID = 0


@dataclass(frozen=True)
class Vocab:
    char_map: Optional[dict]  # token -> id; None for the byte tokenizer
    size: int

    def lookup(self, token: str) -> int:
        if self.char_map is None:
            raise ValueError("byte tokenizer has no char map")
        return self.char_map.get(token, UNK_ID)


def load_vocab(vocab_file: str | os.PathLike) -> Vocab:
    """Load a vocab.txt ('custom' tokenizer). Line i (newline stripped) -> id i."""
    char_map: dict[str, int] = {}
    with open(vocab_file, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            char_map[line[:-1] if line.endswith("\n") else line] = i
    return Vocab(char_map=char_map, size=len(char_map))


def get_tokenizer(dataset_name: str, tokenizer: str = "custom") -> Vocab:
    """'custom' treats ``dataset_name`` as a path to vocab.txt; 'byte' is the
    UTF-8 tokenizer; 'pinyin'/'char' resolve ``data/{name}_{tok}/vocab.txt``
    relative to the working directory."""
    if tokenizer == "byte":
        return Vocab(char_map=None, size=256)
    if tokenizer in ("pinyin", "char"):
        path = os.path.join("data", f"{dataset_name}_{tokenizer}", "vocab.txt")
        vocab = load_vocab(path)
        if vocab.char_map.get(" ") != 0:
            raise ValueError("vocab.txt must map ' ' to id 0 (0 doubles as unknown)")
        return vocab
    if tokenizer == "custom":
        return load_vocab(dataset_name)
    raise ValueError(f"unknown tokenizer type: {tokenizer}")


def text_to_ids(tokens: Sequence[str] | str, vocab: Vocab) -> np.ndarray:
    """One phone/char sequence -> int32 ids (unknown -> 0)."""
    if vocab.char_map is None:
        if isinstance(tokens, str):
            return np.frombuffer(tokens.encode("utf-8"), dtype=np.uint8).astype(np.int32)
        raise ValueError("byte tokenizer expects a plain string")
    return np.asarray([vocab.char_map.get(t, UNK_ID) for t in tokens], dtype=np.int32)


def pad_text_batch(
    seqs: Sequence[np.ndarray], pad_to: Optional[int] = None, padding_value: int = PAD_ID
) -> np.ndarray:
    """Stack variable-length id sequences into [B, nt] with -1 padding."""
    maxlen = max((len(s) for s in seqs), default=0)
    if pad_to is not None:
        maxlen = max(maxlen, pad_to)
    out = np.full((len(seqs), maxlen), padding_value, dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out
