"""The backward kernel's share of its roofline: ``yardstick.bounds.
train_bounds``' backward part over the batches' valid row-steps, over
the kernel's device time in the traced window."""

from benchmark.metrics._kernels import roofline_pct


SYMBOLS = ("drnmf_scan_factored_bwd_kernel",)  # drnmf_scan_factored_bwd.cu


def read(ctx):
    return roofline_pct(ctx, SYMBOLS, "backward_bound_s")
