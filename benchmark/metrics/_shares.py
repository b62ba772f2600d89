"""Shares of the traced window shared by several readers."""

from benchmark.yardstick.peaks import PEAK_TF32_FLOPS


def mfu_pct(ctx):
    """100 x the model's operations in the window (the driver's
    ``model_flops``) over the window's time at the TF32 peak; None where
    the trace saw no device."""
    if ctx["trace"]["busy_s"] is None:
        return None
    return 100.0 * ctx["counters"]["model_flops"] / (
        ctx["window_s"] * PEAK_TF32_FLOPS)


def idle_pct(ctx):
    """100 x the share of the window in which no device operation ran."""
    busy = ctx["trace"]["busy_s"]
    if busy is None:
        return None
    return 100.0 * (1.0 - busy / ctx["window_s"])
