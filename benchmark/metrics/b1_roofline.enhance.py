"""B1's share of its roofline in offline enhancement: the least time of
the recurrence over the signals' own frames (``yardstick.bounds.
factored_bounds``, the larger of one TF32 pass and the bytes) over B1's
device time in the traced window."""

from benchmark.metrics._kernels import roofline_pct


SYMBOLS = ("drnmf_scan_factored_kernel",)  # B1, drnmf_scan_factored.cu


def read(ctx):
    return roofline_pct(ctx, SYMBOLS, "b1_bound_s")
