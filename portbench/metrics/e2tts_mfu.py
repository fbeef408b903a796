"""The UNetT's whole step's share of the chip's peak in the profiled slice,
in %: the frozen FLOP count of the slice's sampler calls
(``portbench/backbones/unett.py:sampler_call_flops``, the time token's
N + 1 included) at the bf16 peak (989.4 TFLOP/s), over the slice's wall."""

from portbench.readings import slice_flops_seconds


def read(run):
    s = slice_flops_seconds(run)
    return 100.0 * s / run.profile.window_s if s else None
