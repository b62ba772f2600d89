"""Per-stage wall-clock with real-time-factor accounting (counterpart of
``StageTimer`` in ``drnmf_tpu/utils/profiling.py``).

``trace`` and the rest of the JAX module wait for ROADMAP.md queue A,
item 10."""

import contextlib
import json
import time

import torch


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
