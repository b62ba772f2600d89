"""B3's share of its roofline in offline enhancement with a dense U: the
least time of the recurrence over the signals' own frames, one launch a
batch (``yardstick.dense_bounds.dense_bounds``, the larger of one TF32
pass and the bytes, the weights past the L2 read again every step), over
B3's device time in the traced window."""

from benchmark.metrics._kernels import roofline_pct


SYMBOLS = ("drnmf_scan_dense_kernel",)  # B3, drnmf_scan_dense.cu


def read(ctx):
    return roofline_pct(ctx, SYMBOLS, "b3_bound_s")
