"""Reference-audio/text preprocessing for zero-shot TTS (counterpart of
``lemas_tts_tpu/infer/preprocess.py``): silence-aware <=12 s clipping,
edge-silence trim + 50 ms pad, sentence-final punctuation. The ASR fallback
for an empty reference text is not ported: pass ``transcribe_fn``."""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np

from lemas_tts_tpu_torch.infer.audio_prep import clip_ref_audio
from lemas_tts_tpu_torch.utils.audio_io import read_audio


def preprocess_ref_audio_text(
    ref_audio: Union[str, Tuple[np.ndarray, int]],
    ref_text: str,
    clip_short: bool = True,
    show_info: Callable = print,
    transcribe_fn: Optional[Callable] = None,
) -> Tuple[np.ndarray, int, str]:
    """Returns (mono float32 wave, sample_rate, ref_text). ``ref_audio`` is a
    path or a decoded ``(wave, sr)`` tuple; ``transcribe_fn(wave, sr) -> str``
    supplies the reference text when ``ref_text`` is empty."""
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
        if transcribe_fn is None:
            raise NotImplementedError(
                "an empty ref_text needs ASR, which the PyTorch port does not "
                "have yet (a later slice ports infer/asr.py); pass the "
                "reference text or a transcribe_fn")
        show_info("No reference text provided, transcribing reference audio...")
        ref_text = transcribe_fn(wav, sr)
    else:
        show_info("Using custom reference text...")

    # sentence-final punctuation (utils_infer.py:385-390)
    if not ref_text.endswith(". ") and not ref_text.endswith("。"):
        ref_text = ref_text + " " if ref_text.endswith(".") else ref_text + ". "
    return wav, sr, ref_text
