"""The readers of the program's spans and counters (``metrics/_spans.py``
and the four metrics that use it) on the tiny CPU cells: a traced run
reports each metric its cell lists, a number in [0, 100];
``pad_waste_pct.enhance`` is the padding arithmetic of the calls the
window ran; and a program that keeps no tally gives no reading."""

import numpy as np
import pytest
import torch

from benchmark.harness import Bench, run_workload

SPAN_METRICS = {
    "tiny-drnmf.tiny-offline": {"dsp_pct.enhance", "host_trip_pct.enhance",
                                "pad_waste_pct.enhance"},
    "tiny-snmf.tiny-offline": {"dsp_pct.enhance", "host_trip_pct.enhance"},
    "tiny-drnmf.tiny-train": {"weight_grad_pct.train"},
}


@pytest.fixture(scope="module")
def traced(tiny_root):
    """One traced run of each tiny cell, and the signals of each call the
    DR-NMF enhancer ran inside a traced window."""
    from drnmf_torch import enhance

    real = enhance.enhance_signals
    calls = []

    def spy(params, config, signals, *args, **kwargs):
        if torch._C._autograd._profiler_enabled():
            calls.append([len(s) for s in signals])
        return real(params, config, signals, *args, **kwargs)

    enhance.enhance_signals = spy
    try:
        results = {cell: run_workload(cell, 2 ** 41 + 17, 0.2, 1,
                                      device="cpu", root=tiny_root)
                   for cell in SPAN_METRICS}
    finally:
        enhance.enhance_signals = real
    return results, calls


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_traced_tiny_cells_report_the_span_metrics(traced, cell):
    result = traced[0][cell]
    assert result["correct"], result["checks"]
    for name in SPAN_METRICS[cell]:
        value = result["metrics"][name]["value"]
        assert 0.0 <= value <= 100.0, (name, value)
        assert result["metrics"][name]["unit"] == "%"


def test_pad_waste_is_the_calls_padding_arithmetic(traced, tiny_root):
    from drnmf_torch.dsp.stft import bucket_total, n_frames_for_length

    results, calls = traced
    config = Bench(tiny_root).config("tiny-drnmf")
    n_fft, hop = config["n_fft"], config["hop"]
    assert len(calls) == results["tiny-drnmf.tiny-offline"]["attempted"]
    run = signal = 0
    for lengths in calls:
        for b0 in range(0, len(lengths), 128):  # enhance_signals' batches
            chunk = lengths[b0:b0 + 128]
            total = max(bucket_total(n, n_fft, hop) for n in chunk)
            run += len(chunk) * (1 + (total - n_fft) // hop)
            signal += sum(n_frames_for_length(n, n_fft, hop) for n in chunk)
    got = results["tiny-drnmf.tiny-offline"]["metrics"][
        "pad_waste_pct.enhance"]["value"]
    assert np.isclose(got, 100.0 * (1.0 - signal / run), rtol=1e-12)


@pytest.mark.parametrize("metric", ["dsp_pct.enhance",
                                    "host_trip_pct.enhance",
                                    "pad_waste_pct.enhance",
                                    "weight_grad_pct.train"])
def test_readers_give_nothing_without_a_tally(tiny_root, monkeypatch,
                                              metric):
    """A program without ``profiling.tally`` (one older than its spans), or
    a window that recorded none of a reader's names."""
    from drnmf_torch.utils import profiling

    reader = Bench(tiny_root).reader(metric)
    ctx = {"window_s": 1.0}
    monkeypatch.setattr(profiling, "tally",
                        lambda: {"spans": {}, "counters": {}})
    assert reader.read(ctx) is None
    monkeypatch.delattr(profiling, "tally")
    assert reader.read(ctx) is None
