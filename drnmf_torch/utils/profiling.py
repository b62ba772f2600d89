"""Tracing and profiling (counterpart of ``drnmf_tpu/utils/profiling.py``):

* ``span`` / ``count`` / ``tally`` -- the program's spans and counters,
  kept in memory while a ``torch.profiler`` session records (the CLI's
  ``--trace``, a benchmark's traced window) and nothing otherwise; each
  span is also a ``torch.profiler.record_function`` range, so it sits in
  the profiler's timeline on the clock of the device's operations;
* ``StageTimer`` -- named wall-clock stages with real-time-factor
  accounting; each stage is also a span;
* ``trace`` -- a ``torch.profiler`` trace around a block, written as a
  Chrome/Perfetto JSON file with the block's tally beside it; a no-op
  without a directory;
* ``device_sync`` -- wait for the card's queued work (nothing on the CPU).

The JAX module's ``enable_compile_cache`` (XLA's persistent compilation
cache) has no counterpart: nothing here is compiled a call."""

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

import torch

# True while a torch.profiler session records on this thread (and on the
# autograd threads that run a backward it started): tracing has no switch
# of its own
_profiling = torch._C._autograd._profiler_enabled


class _Span:
    """One span: its name, parent, call id, host interval
    (``time.perf_counter_ns``) and, where CUDA is in use, a pair of timing
    events recorded on the current stream at entry and exit."""

    __slots__ = ("name", "attrs", "parent", "call", "t0", "t1", "events",
                 "device_s", "_range")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs
        self.t1 = self.events = self.device_s = None

    def __enter__(self):
        _REGISTRY.enter(self)
        self._range = torch.profiler.record_function(
            self.name, json.dumps({"call": self.call, **self.attrs}))
        self._range.__enter__()
        if self.events is not None:
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self._range.__exit__(*exc)
        _REGISTRY.exit(self, t1)
        return False

    def device_seconds(self):
        """The device's time between entry and exit (the host's where no
        event was recorded: the work ran synchronously on the CPU)."""
        if self.device_s is None:
            if self.events is None:
                self.device_s = (self.t1 - self.t0) * 1e-9
            else:
                start, end = self.events
                end.synchronize()
                self.device_s = start.elapsed_time(end) * 1e-3
        return self.device_s


class _Registry:
    """The spans and counters of one traced window.  The first record after
    the main thread saw tracing off starts a new window, so a tally never
    mixes two (other threads see it off all through a window that the
    main thread's profiler records).  Spans nest by a stack shared by the
    process's threads: the autograd thread that runs a backward does so
    while the thread that called ``backward()`` waits, and its spans are
    children of that thread's."""

    def __init__(self):
        self.lock = threading.Lock()
        self.free_events = []  # (start, end) CUDA event pairs to reuse
        self.spans = []
        self.clear()
        self.stale = True  # tracing was seen off since the last record

    def clear(self):
        for s in self.spans:
            if s.events is not None and s.t1 is not None:
                self.free_events.append(s.events)
        self.spans, self.open = [], []
        self.counters = defaultdict(int)
        self.calls = 0
        self.stale = False

    def _fresh(self):
        if self.stale:
            self.clear()

    def enter(self, span):
        with self.lock:
            self._fresh()
            span.parent = self.open[-1] if self.open else None
            if span.parent is None:
                self.calls += 1
                span.call = self.calls
            else:
                span.call = span.parent.call
            if torch.cuda.is_initialized():
                span.events = self.free_events.pop() if self.free_events \
                    else (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            self.open.append(span)
            self.spans.append(span)

    def exit(self, span, t1):
        with self.lock:
            span.t1 = t1
            if span in self.open:  # not where a new window began inside it
                self.open.remove(span)

    def add(self, name, n):
        with self.lock:
            self._fresh()
            self.counters[name] += n

    def tally(self):
        with self.lock:
            if not _profiling():
                self.stale = True
            spans = [s for s in self.spans if s.t1 is not None]
            counters = dict(self.counters)
        children = defaultdict(list)
        for s in spans:
            if s.parent is not None:
                children[id(s.parent)].append((s.t0, s.t1))
        out = {}
        for s in spans:
            host = s.t1 - s.t0
            inner = _covered(s.t0, s.t1, children.get(id(s), ()))
            row = out.setdefault(s.name, {"count": 0, "host_s": 0.0,
                                          "host_self_s": 0.0,
                                          "device_s": 0.0})
            row["count"] += 1
            row["host_s"] += host * 1e-9
            row["host_self_s"] += (host - inner) * 1e-9
            row["device_s"] += s.device_seconds()
        return {"spans": out, "counters": counters}


def _covered(t0, t1, intervals):
    """Length of the union of ``intervals`` inside [t0, t1]."""
    total, edge = 0, t0
    for s, e in sorted(intervals):
        s, e = max(s, edge), min(e, t1)
        if e > s:
            total += e - s
            edge = e
    return total


_REGISTRY = _Registry()
_OFF = contextlib.nullcontext()
_MAIN = threading.main_thread().ident


def _off():
    """Off: the window, if any, has ended (on the main thread)."""
    if threading.get_ident() == _MAIN:
        _REGISTRY.stale = True


def span(name, **attrs):
    """A context manager that records the block as the span ``name`` while
    tracing is on (a ``torch.profiler`` session records): a
    ``record_function`` range whose args hold ``attrs`` and the call id
    (every span inside an outermost span shares its id), the host
    interval, the parent span, and the device's time between entry and
    exit.  Off, it returns a shared null context after one flag check."""
    if not _profiling():
        _off()
        return _OFF
    return _Span(name, attrs)


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while tracing is on; off, nothing
    after one flag check."""
    if not _profiling():
        _off()
        return
    _REGISTRY.add(name, n)


def tally():
    """The traced window's spans and counters: ``{"spans": {name: {count,
    host_s, host_self_s, device_s}}, "counters": {name: n}}``.  ``host_s``
    sums the spans' host durations, ``host_self_s`` the same less what
    their child spans cover, ``device_s`` the device's time between each
    span's entry and exit (CUDA events, resolved here; the host duration
    where CUDA is not in use).  Empty before any window; after one, it
    holds that window until the next window's first record."""
    return _REGISTRY.tally()


def device_sync():
    """Wait until the work queued on the card finishes, so a timer reads
    compute rather than launches; nothing where there is no card."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir=None, device="cuda", rank: int = 0):
    """A ``torch.profiler`` trace of the block, written to
    ``log_dir/trace_rank{rank}.json`` (Chrome trace format: open it in
    Perfetto or chrome://tracing); a no-op when ``log_dir`` is None.
    Records host activity, and the card's kernels when ``device`` is the
    card.  The block's ``tally()`` goes to ``log_dir/spans_rank{rank}.json``.
    Yields the profiler (or None)."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _REGISTRY.stale = True  # the block's spans only
    with torch.profiler.profile(activities=activities,
                                acc_events=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_rank{rank}.json"))
    with open(os.path.join(log_dir, f"spans_rank{rank}.json"), "w") as fh:
        json.dump(tally(), fh, indent=1)


class StageTimer:
    """Named wall-clock stages, each a :func:`span`; the real-time factor
    (audio seconds per second of compute) over the stages given
    ``audio_seconds``.

    Usage::

        timer = StageTimer()
        with timer.stage("predict_irm", audio_seconds=123.4, sync=True):
            ...
        print(timer.report())

    ``sync=True`` waits for the card's queued work (``torch.cuda
    .synchronize()``) before the stage's clock stops, so the stage holds
    its device time and not only its launches.  Stages of one ``group``
    process the same audio one after another (a split's mask prediction
    and its reconstruction): the aggregate counts that audio once, where
    the JAX package's counts it once a stage.  A stage is its own group
    unless given one."""

    def __init__(self):
        self.stages = []  # (name, seconds, audio_seconds)
        self._audio = {}  # group -> audio seconds

    @contextlib.contextmanager
    def stage(self, name, audio_seconds=None, sync=False, group=None):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield self
        finally:
            if sync:
                torch.cuda.synchronize()
            self.stages.append((name, time.perf_counter() - t0,
                                audio_seconds))
            if audio_seconds:
                self._audio[name if group is None else group] = audio_seconds

    def seconds(self, name):
        """Seconds summed over the stages called ``name``."""
        return sum(s for n, s, _ in self.stages if n == name)

    def total_seconds(self):
        return sum(s for _, s, _ in self.stages)

    def audio_seconds(self):
        """The audio the stages processed, each group's once."""
        return sum(self._audio.values())

    def realtime_factor(self):
        """Audio seconds / compute seconds over the stages given audio."""
        compute = sum(s for _, s, a in self.stages if a)
        return (self.audio_seconds() / compute) if compute > 0 \
            else float("inf")

    def report(self):
        lines = []
        for name, secs, audio in self.stages:
            rtf = f"  ({audio / secs:.1f}x real-time)" if audio else ""
            lines.append(f"  {name}: {secs:.3f}s{rtf}")
        lines.append(f"  total: {self.total_seconds():.3f}s")
        if self._audio:
            lines.append(
                f"  real-time factor: {self.realtime_factor():.1f}x "
                f"({self.audio_seconds():.1f}s audio)")
        return "\n".join(lines)

    def to_json(self):
        rtf = self.realtime_factor()
        return json.dumps({
            "stages": [{"name": n, "seconds": s, "audio_seconds": a}
                       for n, s, a in self.stages],
            "total_seconds": self.total_seconds(),
            # None, not float('inf'): json.dumps would write Infinity
            "realtime_factor": rtf if rtf != float("inf") else None,
        })
