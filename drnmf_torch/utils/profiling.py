"""Tracing and profiling (counterpart of ``drnmf_tpu/utils/profiling.py``):

* ``StageTimer`` -- named wall-clock stages with real-time-factor
  accounting; each stage is also a ``torch.profiler.record_function``
  range, so its name shows in a trace;
* ``trace`` -- a ``torch.profiler`` trace around a block, written as a
  Chrome/Perfetto JSON file; a no-op without a directory;
* ``device_sync`` -- wait for the card's queued work (nothing on the CPU).

The JAX module's ``enable_compile_cache`` (XLA's persistent compilation
cache) has no counterpart: nothing here is compiled a call."""

import contextlib
import json
import os
import time

import torch


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
    card.  Yields the profiler (or None)."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                acc_events=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_rank{rank}.json"))


class StageTimer:
    """Named wall-clock stages; the real-time factor (audio seconds per
    second of compute) over the stages given ``audio_seconds``.

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
            with torch.profiler.record_function(name):
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
