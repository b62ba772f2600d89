"""One reader a per-layer metric, ``metrics/<metric>.py``, found by the
metric's name.  ``read(ctx)`` returns the metric's value, or None where
the run holds nothing to read (then the metric is left out of the line).
``ctx``: ``trace`` (``yardstick.trace.summarize`` of the traced window),
``counters`` (the driver's), ``config``, ``traffic`` and ``window_s``."""
