"""The share of the frames the DR-NMF enhancer runs that is padding: each
batch is padded to its longest signal's sample bucket and the recurrence
runs every frame.  100 x (1 - ``enhance.frames_signal`` /
``enhance.frames_run``), the program's counters over the traced window's
calls."""

from benchmark.metrics._spans import counters

NAMES = ("enhance.frames_signal", "enhance.frames_run")


def read(ctx):
    got = counters(NAMES)
    if got is None or got[1] <= 0:
        return None
    return 100.0 * (1.0 - got[0] / got[1])
