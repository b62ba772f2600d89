"""The DSP layer's share of the traced window: the device time of the
program's spans ``dsp.stft`` and ``dsp.istft`` (``dsp/stft.py::
stft_frames``, ``istft_frames``; each span's device time from CUDA events
at its entry and exit) over the window."""

from benchmark.metrics._spans import span_pct

SPANS = ("dsp.stft", "dsp.istft")


def read(ctx):
    return span_pct(ctx, SPANS)
