"""The dense route's preparation as a share of the traced window: the
device time of the program's spans ``drnmf.dense_weights`` (``models/
drnmf.py::make_scan``: dense U, S, W and b and B3's weight stacks, built
each call) and ``scan.dense_stage`` (``ops/drnmf_scan.py::
drnmf_scan_dense``: B3's scratch, x batch-major, before the launch) over
the window."""

from benchmark.metrics._spans import span_pct

SPANS = ("drnmf.dense_weights", "scan.dense_stage")


def read(ctx):
    return span_pct(ctx, SPANS)
