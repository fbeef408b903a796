"""The whole step's share of the chip's peak in the profiled slice, in %: the
frozen FLOP count of the slice's sampler calls, each product at the peak of
its precision (bf16 989.4 TFLOP/s, int8 1979 TOP/s), over the slice's wall."""

from portbench.readings import slice_flops_seconds


def read(run):
    s = slice_flops_seconds(run)
    return 100.0 * s / run.profile.window_s if s else None
