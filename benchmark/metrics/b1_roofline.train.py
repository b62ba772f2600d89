"""B1's share of its roofline in training (B1 with every layer kept):
``yardstick.bounds.train_bounds``' forward part over the batches' valid
row-steps, over B1's device time in the traced window."""

from benchmark.metrics._kernels import roofline_pct


SYMBOLS = ("drnmf_scan_factored_kernel",)  # B1, drnmf_scan_factored.cu


def read(ctx):
    return roofline_pct(ctx, SYMBOLS, "forward_bound_s")
