"""espeak-ng IPA tokenizer wrapper (host-side, gated external dep).

Produces the reference phone-string format (``text_norm/tokenizer.py:49-130``):
phones separated by ``|``, words separated by ``_``, espeak language-switch
flags kept inline as ``(lang)`` tokens. The phone format feeds the 898-token
custom vocab, so the separator conventions here are checkpoint contract.

espeak-ng is a C library loaded via ``phonemizer`` (+ optional
``espeakng_loader`` for bundled data paths, mirroring ``tokenizer.py:33-46``);
``available()`` reports whether the backend can be constructed so callers can
fall back to the char frontend.

Copy of ``lemas_tts_tpu/text/tokenizer.py``, its two codec wrappers
(``AudioTokenizer``, ``AudioSR``, which no entry point calls) gated on their
optional packages as there. Pause markers follow :data:`PAUSE_TOKENS`: only
an exact ``#1``-``#4`` is one.
"""

from __future__ import annotations

import math
import os
import re
from typing import List

_PAUSE_SYMBOL = {"、": ",", "，": ",", "。": ",", "！": "!", "？": "?", "：": ":"}

# The pause grammar of the vocab: ``#1``-``#4`` and nothing else. A ``#``
# followed by anything else is ordinary text (the JAX package passes ``#:``,
# ``#a`` or ``#5`` through as one glued, out-of-vocab token).
PAUSE_TOKENS = frozenset({"#1", "#2", "#3", "#4"})
_PAUSE_RE = re.compile(r"(#[1-4])")


def split_pauses(text: str) -> List[str]:
    """``text`` split around its pause markers, which stay as parts of their
    own (``re.split`` with a capture: pauses sit at the odd indices)."""
    return _PAUSE_RE.split(text)


_backend_error = None
try:
    try:  # prefer bundled espeak data (reference tokenizer.py:33-46)
        import espeakng_loader

        os.environ.setdefault("PHONEMIZER_ESPEAK_LIBRARY",
                              espeakng_loader.get_library_path())
        data_path = espeakng_loader.get_data_path()
        os.environ.setdefault("ESPEAK_DATA_PATH", data_path)
        os.environ.setdefault("ESPEAKNG_DATA_PATH", data_path)
    except Exception:
        pass
    from phonemizer.backend import EspeakBackend
    from phonemizer.separator import Separator

    _HAVE_ESPEAK = True
except Exception as e:  # phonemizer or espeak-ng missing
    _HAVE_ESPEAK = False
    _backend_error = e


def available() -> bool:
    return _HAVE_ESPEAK


class TextTokenizer:
    """One espeak phonemizer per language (reference ``TextTokenizer``)."""

    def __init__(self, language: str = "en-us", backend: str = "espeak"):
        if not _HAVE_ESPEAK:
            raise RuntimeError(
                f"espeak phone frontend unavailable ({_backend_error}); "
                "install `phonemizer` + espeak-ng or use the char frontend"
            )
        assert backend == "espeak", backend
        self.separator = Separator(word="_", syllable="-", phone="|")
        self.backend = EspeakBackend(
            language,
            preserve_punctuation=True,
            with_stress=False,
            tie=False,
            language_switch="keep-flags",
            words_mismatch="ignore",
        )

    def to_list(self, phonemized: str) -> List[str]:
        """Split a phonemized string into tokens, keeping punctuation as its
        own token and ``_`` word separators (``tokenizer.py:77-90``)."""
        fields: List[str] = []
        for word in phonemized.split(self.separator.word):
            parts = re.findall(r"\w+|[^\w\s]", word, re.UNICODE)
            fields.extend([p for p in parts if p != self.separator.phone])
            fields.append(self.separator.word)
        return fields[:-1]

    def phonemize_to_tokens(self, text: str) -> List[str]:
        ipa = self.backend.phonemize(
            [text], separator=self.separator, strip=True, njobs=1
        )
        return self.to_list(ipa[0])


def txt2phone(tokenizer: TextTokenizer, text: str) -> str:
    """Text → ``|``-joined phone string, preserving ``#1``-``#4`` pause markers and
    mapping CJK punctuation to ASCII (reference ``tokenizer.py:111-130``)."""
    text = re.sub("|".join(_PAUSE_SYMBOL), lambda m: _PAUSE_SYMBOL[m.group(0)], text)
    phones: List[str] = []
    for part in split_pauses(text):
        if part in PAUSE_TOKENS:
            phones.append(part)
        elif part:
            phones += tokenizer.phonemize_to_tokens(part)
    return "|".join(phones).replace("(|", "(").replace("|)", ")")


class AudioTokenizer:
    """Neural audio codec tokenizer (reference ``tokenizer.py:146-178``: an
    EnCodec wrapper via audiocraft, defined but never called by any entry
    point). Kept for API parity, gated on the optional dependency. Runs on
    CUDA unless ``device="cpu"`` (``api.select_device``)."""

    def __init__(self, device=None, signature=None) -> None:
        try:
            from audiocraft.solvers import CompressionSolver  # optional dep
        except ImportError as e:
            raise ImportError(
                "AudioTokenizer needs the optional 'audiocraft' package "
                "(unused by the TTS pipeline; reference tokenizer.py:146-178)") from e
        from lemas_tts_tpu_torch.api import select_device

        self._device = select_device(device)
        model = CompressionSolver.model_from_checkpoint(signature)
        self.sample_rate = model.sample_rate
        self.channels = model.channels
        self.codec = model.to(self._device)

    @property
    def device(self):
        return self._device

    def encode(self, wav):
        codes = self.codec.encode(wav.to(self._device))
        return [(codes[0], None)]

    def decode(self, frames):
        return self.codec.decode(frames[0][0])


class AudioSR:
    """DAC codec wrapper (reference ``tokenizer.py:199-235``, defined but
    never called). Kept for API parity, gated on the optional dependency.
    Runs on CUDA unless ``device="cpu"`` (``api.select_device``)."""

    def __init__(self, model_path, device=None) -> None:
        try:
            import dac  # optional dep
        except ImportError as e:
            raise ImportError(
                "AudioSR needs the optional 'descript-audio-codec' package "
                "(unused by the TTS pipeline; reference tokenizer.py:199-235)") from e
        from lemas_tts_tpu_torch.api import select_device

        self._device = select_device(device)
        self.codec = dac.DAC.load(model_path)
        self.codec.to(self._device)
        self.codec.eval()
        self.sample_rate = self.codec.sample_rate
        self.channels = 1

    @property
    def device(self):
        return self._device

    def encode(self, wav):
        import torch

        length = wav.shape[-1]
        hop = self.codec.hop_length
        pad = math.ceil(length / hop) * hop - length
        wav = torch.nn.functional.pad(wav, (0, pad))
        z, codes, _, _, _ = self.codec.encode(wav.to(self._device))
        return [(codes, z)]

    def decode(self, frames):
        import torch

        with torch.no_grad():
            return self.codec.decode(frames[0][1])
