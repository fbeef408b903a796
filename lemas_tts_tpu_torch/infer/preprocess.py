"""Reference-audio/text preprocessing for zero-shot TTS (counterpart of
``lemas_tts_tpu/infer/preprocess.py``): silence-aware <=12 s clipping,
edge-silence trim + 50 ms pad, ASR of an empty reference text (Whisper,
``infer/asr.py``, or an injected ``transcribe_fn``) cached by the md5 of the
sample rate and the wave in a FIFO of 256 entries, and sentence-final
punctuation."""

from __future__ import annotations

import hashlib
from typing import Callable, Optional, Tuple, Union

import numpy as np

from lemas_tts_tpu_torch.infer.audio_prep import clip_ref_audio
from lemas_tts_tpu_torch.utils.audio_io import read_audio

CACHE_SIZE = 256  # transcripts kept, oldest dropped first
_ref_audio_cache: dict = {}


def preprocess_ref_audio_text(
    ref_audio: Union[str, Tuple[np.ndarray, int]],
    ref_text: str,
    clip_short: bool = True,
    show_info: Callable = print,
    transcribe_fn: Optional[Callable] = None,
) -> Tuple[np.ndarray, int, str]:
    """Returns (mono float32 wave, sample_rate, ref_text). ``ref_audio`` is a
    path or a decoded ``(wave, sr)`` tuple; ``transcribe_fn(wave, sr) -> str``
    supplies the reference text when ``ref_text`` is empty (default:
    ``infer/asr.transcribe``, which runs on CUDA); the same wave at the same
    rate is transcribed once."""
    if isinstance(ref_audio, (tuple, list)):
        wav, sr = ref_audio
        wav = np.asarray(wav, dtype=np.float32)
    else:
        wav, sr = read_audio(str(ref_audio))
    if wav.ndim == 2:
        wav = wav.mean(axis=0)

    if clip_short:
        wav = clip_ref_audio(wav, sr, show_info=show_info)

    if not ref_text.strip():
        # the key includes the rate: the same bytes at another rate are other audio
        audio_hash = hashlib.md5(f"{sr}:".encode() + wav.tobytes()).hexdigest()
        if audio_hash in _ref_audio_cache:
            show_info("Using cached reference text...")
            ref_text = _ref_audio_cache[audio_hash]
        else:
            show_info("No reference text provided, transcribing reference audio...")
            if transcribe_fn is not None:
                ref_text = transcribe_fn(wav, sr)
            else:
                from lemas_tts_tpu_torch.infer.asr import transcribe

                ref_text = transcribe((wav, sr))
            if len(_ref_audio_cache) >= CACHE_SIZE:
                _ref_audio_cache.pop(next(iter(_ref_audio_cache)))
            _ref_audio_cache[audio_hash] = ref_text
    else:
        show_info("Using custom reference text...")

    # sentence-final punctuation (utils_infer.py:385-390)
    if not ref_text.endswith(". ") and not ref_text.endswith("。"):
        ref_text = ref_text + " " if ref_text.endswith(".") else ref_text + ". "
    return wav, sr, ref_text
