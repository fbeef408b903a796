"""PyTorch/CUDA port of ``lemas_tts_tpu``: zero-shot multilingual TTS on an
NVIDIA H100, with the DiT block's kernels hand-written for Hopper.

The JAX package ``lemas_tts_tpu`` is the reference this port is held
against; nothing here imports it or JAX. ``TTS`` is the public entry point.
"""


def __getattr__(name):
    if name == "TTS":
        from lemas_tts_tpu_torch.api import TTS

        return TTS
    raise AttributeError(name)


__all__ = ["TTS"]
