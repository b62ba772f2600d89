"""The whole enhance path's share of the chip's TF32 peak: the model's
operations for the window's work (the driver's count) over the traced
window's time and 495 TFLOP/s."""

from benchmark.metrics._shares import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
