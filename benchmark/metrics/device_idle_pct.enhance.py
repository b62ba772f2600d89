"""The device's idle share of the traced window: 1 - the union of its
operations' intervals over the window, in %."""

from benchmark.metrics._shares import idle_pct


def read(ctx):
    return idle_pct(ctx)
