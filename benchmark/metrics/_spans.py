"""Arithmetic the readers of the program's own spans and counters share
(``drnmf_torch.utils.profiling``: ``span``, ``count``, ``tally``).  A
program without them (or a window that recorded none of a reader's names)
gives None, and the metric is left out of the line."""


def tally():
    """The program's tally of the traced window, or None where the program
    keeps none."""
    from drnmf_torch.utils import profiling

    read = getattr(profiling, "tally", None)
    return read() if read is not None else None


def span_pct(ctx, names):
    """100 x the device seconds of the spans ``names`` over the traced
    window; None where the window recorded none of them."""
    got = tally()
    spans = (got or {}).get("spans", {})
    if not any(n in spans for n in names):
        return None
    secs = sum(spans[n]["device_s"] for n in names if n in spans)
    return 100.0 * secs / ctx["window_s"]


def counters(names):
    """The program's counters ``names`` of the traced window, or None where
    any is missing."""
    got = (tally() or {}).get("counters", {})
    if not all(n in got for n in names):
        return None
    return [got[n] for n in names]
