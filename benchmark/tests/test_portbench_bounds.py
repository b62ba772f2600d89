"""The yardstick's arithmetic on hand-counted shapes."""

from types import SimpleNamespace

import pytest

from benchmark.metrics._kernels import mu_split, roofline_pct
from benchmark.yardstick import bounds, trace
from benchmark.yardstick.peaks import PEAK_BYTES_PER_S, PEAK_TF32_FLOPS


def test_bounds_of_takes_the_larger_bound():
    b = bounds.bounds_of(495e12, 3.35e11)
    assert b["bound_s"] == pytest.approx(1.0) and b["bound_by"] == "operations"
    b = bounds.bounds_of(1.0, 3.35e12)
    assert b["bound_s"] == pytest.approx(1.0) and b["bound_by"] == "bytes"


def test_factored_bounds_count_the_frames_given():
    # K = 2, F = 3, 2r = 4, 2 rows, 10 row-steps
    b = bounds.factored_bounds(2, 10, 3, 4, 2)
    assert b["flops"] == 2 * 3 * 4 * 3 * 10
    weights = (4 + 2 + 1 * 4 * 3 + 2 * 3 * 4 + 2 * 4) * 4
    assert b["bytes"] == 10 * 3 * 4 + 10 + 2 * 4 * 4 + weights + 10 * 4 * 4
    # the flagship's B1 at 256 x 1,021 (chip_smoke.py: 2.418 TFLOP)
    big = bounds.factored_bounds(256, 256 * 1021, 257, 2000, 5)
    assert big["flops"] == pytest.approx(2.418e12, rel=1e-3)
    assert big["bound_s"] == pytest.approx(big["flops"] / PEAK_TF32_FLOPS)


def test_train_bounds_parts():
    p = bounds.train_bounds(1, 2, 3, 4, 2, 2, 5)
    assert p["forward"]["flops"] == 2 * 3 * 4 * 3 * 2
    assert p["backward"]["flops"] == 2 * 3 * 4 * 2 * 1 * 2
    assert p["weight_grads"]["flops"] == 4 * 2 * 3 * 4 * 2
    assert p["heads_loss_adam"]["flops"] == 3 * 2 * 3 * 4 * 2
    plane = 1 * 2 * 4 * 4
    assert p["heads_loss_adam"]["bytes"] == 2 * plane + 2 * 24 + 7 * 4 * 5
    assert bounds.train_model_flops(p) == sum(
        x["flops"] for x in p.values())
    # the flagship step at 32 x 500, all valid (chip_smoke.py: the backward
    # kernel's bound 0.445 ms, by bytes)
    f = bounds.train_bounds(32, 500, 257, 2000, 5, 16000, 0)
    assert f["backward"]["bound_by"] == "bytes"
    assert f["backward"]["bound_s"] == pytest.approx(0.445e-3, rel=0.01)


def test_snmf_bounds_and_model_flops():
    b = bounds.snmf_bounds(2, 3, 5)
    assert b["pass1"]["flops"] == 6 * 2 * 2 * 3 * 5
    assert b["pass2"]["flops"] == 2 * 2 * 3 * 5
    inputs = 4 * (10 + 15 + 6)
    assert b["pass1"]["bytes"] == inputs + 4 * (15 + 12 + 1)
    assert b["pass2"]["bytes"] == inputs + 4
    big = bounds.snmf_bounds(257, 2000, 140_000)["pass2"]
    assert big["bound_s"] == pytest.approx(big["bytes"] / PEAK_BYTES_PER_S)
    assert bounds.snmf_model_flops(7, 3, 4, 10) == 2 * 3 * 4 * 22 * 7
    assert bounds.drnmf_model_flops(7, 3, 4, 5) == 2 * 3 * 4 * 10 * 7


def _event(name, start, end, device):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_summarize_busy_gaps_and_annotations():
    cuda, cpu = "DeviceType.CUDA", "DeviceType.CPU"
    events = [
        _event(trace.WINDOW, 0.0, 100.0, cpu),
        _event(trace.WINDOW, 0.0, 100.0, cuda),  # the range's annotation
        _event("step", 0.0, 60.0, cpu),
        _event("copy", 60.0, 100.0, cpu),
        _event("kernel_a", 10.0, 30.0, cuda),
        _event("kernel_b", 20.0, 40.0, cuda),
        _event("kernel_a", 70.0, 80.0, cuda),
        _event("before", -50.0, -10.0, cuda),  # outside the window
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["device_ops"][0] == ["kernel_a", pytest.approx(30e-6)]
    idle = dict(s["idle_gaps"])
    assert idle["step"] == pytest.approx(40e-6)  # 0-10, 40-70 (mid 55)
    assert idle["copy"] == pytest.approx(20e-6)  # 80-100
    ctx = {"trace": s, "counters": {"bound": 15e-6}}
    assert roofline_pct(ctx, ("kernel_a",), "bound") == pytest.approx(50.0)
    assert roofline_pct(ctx, ("missing",), "bound") is None


def test_mu_split_puts_each_launch_to_its_pass():
    us = 1e6
    device = [
        (0, 1 * us, "mu_gemm<88, 1, false, 4, 8, 0>(Args)"),
        (1 * us, 2 * us, "mu_gemm<64, 2, false, 4, 0, 1>(Args)"),
        (2 * us, 3 * us, "sum_slices(float const*)"),
        (3 * us, 4 * us, "sum_partials(float const*)"),
        (4 * us, 6 * us, "mu_gemm<88, 1, false, 4, 8, 3>(Args)"),
        (6 * us, 7 * us, "sum_partials(float const*)"),
        (7 * us, 8 * us, "elementwise_kernel"),
    ]
    b4, b5 = mu_split(device, "mu_gemm<", "3",
                      ("sum_slices", "sum_partials"), "sum_partials")
    assert b4 == pytest.approx(4.0) and b5 == pytest.approx(3.0)
