"""The weight-gradient products' share of the traced window: the device
time of the program's span ``grad.weight_grads`` (``models/batched_grad.py
::_weight_grads``, one product a weight over T x Bp after the backward
kernel) over the window."""

from benchmark.metrics._spans import span_pct

SPANS = ("grad.weight_grads",)


def read(ctx):
    return span_pct(ctx, SPANS)
