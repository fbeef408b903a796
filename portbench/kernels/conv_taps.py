"""The conv position embedding's kernel (``csrc/conv_taps.cu``,
``ops/conv.py:conv_taps_mish``): a grouped k=31 convolution of 16 groups with
Mish, channel-last, on the forward's rows. The DiT, UNetT and MMDiT run it
twice in each forward's input embedding (``models/modules.py:
ConvPositionEmbedding``), with or without W8A8.

Bytes and operations as ``chip_smoke.py:conv_case`` counts them (``PERF.md``
§6's conv row, PR 21): the input, the output, the taps and the bias once
each, in bf16; ``2 · rows · N · dim · dim/16 · 31`` FLOP. At rows 2, N 1024,
dim 1024 that is 0.0084 ms at the bf16 peak, at N 1536 0.0126 ms. Only the
bf16 kernel's launches count: the copy that makes the taps before each
launch is another kernel (ATen's), and is not the conv kernel's time.
"""

import re

SYMBOL = re.compile(r"conv_taps_sm90_kernel")
CALL_MARK = None  # one launch, one call
PER = "forward"
GROUPS, KSIZE, ESZ = 16, 31, 2
RUN_BY = ("DiT", "UNetT", "MMDiT")  # the backbones whose input embedding holds it


def calls(config: dict, quant) -> int:
    return 2 if config["model"]["backbone"] in RUN_BY else 0


def cost(config: dict, rows: int, n: int, valid_keys: float) -> tuple:
    """(bytes, FLOP) of one call on ``rows`` rows of ``n`` frames."""
    c = config["model"]["arch"]["dim"]
    taps = c * (c // GROUPS) * KSIZE
    nbytes = (rows * n * c + rows * n * c + taps + c) * ESZ
    return nbytes, 2.0 * rows * n * c * (c // GROUPS) * KSIZE
