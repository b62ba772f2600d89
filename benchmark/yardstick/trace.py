"""The reduction of a ``torch.profiler`` trace of the measured window.

Adapted from chip_smoke.py:897-927 (``profile_split``: device time by
kernel name and the idle share from the profiler), extended from one call
to a window: the device's busy time is the union of its operations'
intervals inside the window (a range named ``WINDOW`` that the harness
records), the idle time is the rest of the window, and each idle gap is
put down to the innermost host range that covers its middle, which says
what the host was doing while the device waited."""

import heapq
from collections import defaultdict

WINDOW = "bench.window"
NAME_CHARS = 120


def _is_device(event):
    return str(event.device_type).split(".")[-1] in ("CUDA", "PrivateUse1")


def summarize(events, top=10):
    """``events``: the profiler's ``events()``.  Returns ``window_s``,
    ``busy_s`` (None where no device operation was traced), ``device``
    (the device operations inside the window as (start_us, end_us, name),
    in time order), and ``device_ops`` / ``idle_gaps``: the ``top``
    largest [name, seconds] by device time and by idle time."""
    window = None
    device, host = [], []
    for e in events:
        start, end = float(e.time_range.start), float(e.time_range.end)
        if _is_device(e):
            device.append((start, end, e.name))
        elif e.name == WINDOW:
            window = (start, end)
        else:
            host.append((start, end, e.name))
    if window is None:
        raise ValueError(f"the trace holds no '{WINDOW}' range")
    # a host range also shows on the device's timeline as an annotation
    # of the same name, which is no device work
    ranges = {n for _, _, n in host} | {WINDOW}
    device = [d for d in device if d[2] not in ranges]
    w0, w1 = window
    device = sorted((max(s, w0), min(e, w1), n) for s, e, n in device
                    if e > w0 and s < w1)
    by_name = defaultdict(float)
    for s, e, n in device:
        by_name[n[:NAME_CHARS]] += (e - s) * 1e-6
    # the union of the device's intervals, and the gaps between them
    busy, gaps, edge = 0.0, [], w0
    for s, e, _ in device:
        if s > edge:
            gaps.append((edge, s))
        if e > edge:
            busy += e - max(s, edge)
            edge = e
    if w1 > edge:
        gaps.append((edge, w1))
    idle = _attribute(gaps, host)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6 if device else None,
        "device": device,
        "device_ops": _ranked(by_name, top),
        "idle_gaps": _ranked(idle, top),
    }


def _attribute(gaps, host):
    """Seconds of idle device time by the innermost host range that covers
    each gap's middle (the latest-started range still open there);
    ``host:python`` where no range covers it (the host ran Python code
    outside any traced operation)."""
    out = defaultdict(float)
    host = sorted(host)
    heap, i = [], 0  # max-heap on the start: (-start, end, name)
    for g0, g1 in sorted(gaps):
        mid = 0.5 * (g0 + g1)
        while i < len(host) and host[i][0] <= mid:
            s, e, n = host[i]
            heapq.heappush(heap, (-s, e, n))
            i += 1
        while heap and heap[0][1] <= mid:
            heapq.heappop(heap)
        name = heap[0][2][:NAME_CHARS] if heap else "host:python"
        out[name] += (g1 - g0) * 1e-6
    return out


def _ranked(seconds_by_name, top):
    ranked = sorted(seconds_by_name.items(), key=lambda kv: -kv[1])
    return [[name, secs] for name, secs in ranked[:top]]


def device_seconds(device, match):
    """Seconds of the device operations whose name ``match(name)`` accepts."""
    return sum((e - s) * 1e-6 for s, e, n in device if match(n))
