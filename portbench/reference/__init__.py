"""The plain reference that decides ``correct``: a request worked out again
from its inputs in float32 (float64 for the audio front end) with nothing
but ``torch`` and ``numpy``. It imports no module of the measured program
and takes nothing the program made: the weights come from the benchmark
(``portbench/weights.py``), and the noise, the durations, the buckets, the
reference mel and the quantized weights are derived here again.

- ``audio``: RMS, polyphase resampling, the log-mel, cross-fade;
- ``dit``: the DiT velocity (text embedding, input embedding, blocks, head,
  the block-range cache), with optional W8A8 / W4A4 emulation of the block
  products;
- ``vocos``: the Vocos decoder and its iSTFT (``torch.istft``);
- ``request``: one request end to end (prep, duration, sampler, vocoder,
  RMS restore), as the serving and the single-stream entry points define it,
  through the reference halves of the configuration's backbone and vocoder
  families (``portbench/backbones/``, ``vocoders/``), which it is handed.
"""
