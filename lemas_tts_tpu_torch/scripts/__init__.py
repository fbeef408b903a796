"""Command-line entry points of the port (counterparts of
``lemas_tts_tpu/scripts/``, same flags and defaults):

 - ``tts_multilingual``         — zero-shot multilingual TTS
 - ``speech_edit_multilingual`` — alignment-JSON-driven speech editing
 - ``g2p``                      — offline batch text → phone strings
 - ``serve_http``               — the HTTP server on the batching engine
 - ``denoise``                  — UVR5 denoising of WAV files
 - ``train``                    — CFM training with checkpoints and resume
 - ``distill``                  — progressive distillation into few-step students
 - ``evaluate``                 — objective metrics of synthesized audio
 - ``kernel_check``, ``profile_sampler``, ``latency_probe``, ``parity_check``
   and the ``*_probe`` scripts — the measurement tools (correctness gate,
   trace and mfu, serving latency, checkpoint parity, sampler trades)

Run as modules: ``python -m lemas_tts_tpu_torch.scripts.tts_multilingual
--help``. They run on CUDA unless ``--device cpu`` is given, and never fall
back to another device. An empty ``--ref_text`` and ``evaluate --asr``
transcribe with Whisper (``infer/asr.py``, which needs ``transformers``).
``serve_http --multihost``, ``denoise --data_parallel``, ``train`` (with
``--model_parallel``, ``--pipe_parallel``, ``--microbatches``, ``--fsdp``)
and ``distill`` (``--model_parallel``) run multi-GPU under ``torchrun``.
"""
