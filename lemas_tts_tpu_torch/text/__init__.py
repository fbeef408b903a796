"""Host-side multilingual text frontend (copy of ``lemas_tts_tpu/text/``).

Everything in this package is plain Python on the host: it turns text into
phone or character units, and the model consumes their token ids only.
External G2P backends (espeak-ng via phonemizer, jieba, pypinyin, langid) are
used when installed; each degrades to a built-in pure-Python fallback (the
built-in IPA tier, heuristic language id, built-in number reading,
lexicon-based pinyin), so the frontend runs with none of them.

One intentional difference from the JAX package: only an exact ``#1``-``#4``
is a pause token. A ``#`` followed by anything else is ordinary text (its own
punctuation token), on every branch of ``text2phn``; the JAX package passes
``#:``, ``#a`` or ``#5`` through as one glued, out-of-vocab token.
"""

from lemas_tts_tpu_torch.text.frontend import TextNorm

__all__ = ["TextNorm"]
