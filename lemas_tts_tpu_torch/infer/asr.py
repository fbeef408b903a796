"""ASR: Whisper transcription of reference audio (counterpart of the torch
backend of ``lemas_tts_tpu/infer/asr.py``, as in the reference
``utils_infer.py:167-198``).

``transcribe`` runs the ``transformers`` automatic-speech-recognition
pipeline of ``LEMAS_ASR_MODEL`` (default ``openai/whisper-large-v3-turbo``)
with the JAX package's call: 30 s chunks, batch 128, ``task="transcribe"``
and the language when one is given. The pipeline is built once and kept in
the module (``_asr_pipe``); tests put one built from injected components
there.

Differences from the JAX package:
 - The pipeline runs on the caller's device: ``TTS`` passes its own, and
   ``device=None`` means CUDA (raising without it), as every entry point of
   the port. The JAX package takes CUDA when present and the CPU otherwise;
   the port never chooses another device. A kept pipeline on another device
   is replaced by one on the device asked for. float16 on CUDA, float32 on
   the CPU, as in JAX.
 - A path is read with the port's WAV reader (``utils/audio_io.py``), and a
   wave at another rate than the feature extractor's (16 kHz) is resampled
   by the port's resampler (``ops/resample.py``) before the pipeline sees
   it: the pipeline would decode a path with ``ffmpeg`` and resample with
   ``torchaudio``, which the port does not depend on.
 - ``LEMAS_ASR_BACKEND=flax`` (Flax Whisper, which runs on JAX) raises
   ``NotImplementedError``.
 - ``transformers`` is imported at first use; without it the call raises an
   ``ImportError`` that names it. There is no fallback.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

_asr_pipe = None

DEFAULT_MODEL = "openai/whisper-large-v3-turbo"


def _device_index(dev: torch.device):
    if dev.type == "cuda" and dev.index is None:
        return torch.cuda.current_device()
    return dev.index


def initialize_asr_pipeline(device=None, dtype: Optional[torch.dtype] = None):
    """The transformers ASR pipeline on ``device`` (None: CUDA), built once
    and kept; one kept on another device is replaced."""
    global _asr_pipe
    from lemas_tts_tpu_torch.api import select_device

    dev = select_device(None if device is None else str(device))
    if _asr_pipe is not None:
        have = torch.device(_asr_pipe.device)
        if have.type == dev.type and _device_index(have) == _device_index(dev):
            return _asr_pipe
    try:
        from transformers import pipeline
    except ImportError as e:
        raise ImportError(
            "ASR (an empty reference text, TTS.transcribe, evaluate --asr) needs the "
            "'transformers' package, which cannot be imported; pass the reference text, "
            "or a transcribe_fn") from e
    if dtype is None:
        dtype = torch.float16 if dev.type == "cuda" else torch.float32
    _asr_pipe = pipeline("automatic-speech-recognition",
                         model=os.environ.get("LEMAS_ASR_MODEL", DEFAULT_MODEL),
                         torch_dtype=dtype, device=dev)
    return _asr_pipe


def transcribe(ref_audio: Union[str, Tuple[np.ndarray, int]], language: Optional[str] = None,
               device=None) -> str:
    """Transcribe a WAV path or a ``(wave, sr)`` pair on ``device`` (None:
    CUDA)."""
    if os.environ.get("LEMAS_ASR_BACKEND", "torch").lower() == "flax":
        raise NotImplementedError(
            "LEMAS_ASR_BACKEND=flax: the Flax Whisper backend runs on JAX, which the "
            "PyTorch port does not use; unset it for the transformers pipeline")
    pipe = initialize_asr_pipeline(device)
    if isinstance(ref_audio, (tuple, list)):
        wav, sr = ref_audio
    else:
        from lemas_tts_tpu_torch.utils.audio_io import read_audio

        wav, sr = read_audio(str(ref_audio))
    wav = np.asarray(wav, dtype=np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=0)
    rate = pipe.feature_extractor.sampling_rate
    if sr != rate:
        from lemas_tts_tpu_torch.ops.resample import resample

        wav, sr = resample(torch.from_numpy(wav), sr, rate).numpy(), rate
    result = pipe({"array": wav, "sampling_rate": sr}, chunk_length_s=30, batch_size=128,
                  generate_kwargs=({"task": "transcribe", "language": language} if language
                                   else {"task": "transcribe"}),
                  return_timestamps=False)
    return result["text"].strip()
