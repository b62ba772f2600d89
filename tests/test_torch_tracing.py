"""The port's spans and counters (``drnmf_torch.utils.profiling``: ``span``,
``count``, ``tally``) on the CPU: nothing is recorded while no
``torch.profiler`` session records; under one, spans nest, share their
outermost span's call id and have self times of their total less their
children's; each traced window starts from an empty tally; and the
program's paths record the spans and counters the benchmark's readers
read (``enhance_signals``, ``snmf_infer_irm``, the train step)."""

import time

import numpy as np
import pytest
import torch

from drnmf_torch.convert import init_drnmf_params
from drnmf_torch.dsp.stft import bucket_total, n_frames_for_length
from drnmf_torch.enhance import enhance_signals
from drnmf_torch.models.drnmf import DRNMFConfig, drnmf_forward
from drnmf_torch.models.drnmf import drnmf_trainable_mask
from drnmf_torch.models.snmf_enhancer import snmf_infer_irm
from drnmf_torch.ops.snmf import SNMFParams
from drnmf_torch.train import loop, losses
from drnmf_torch.utils import StageTimer, profiling
from drnmf_torch.utils.profiling import count, span, tally

N_FFT, HOP = 64, 16
F = N_FFT // 2 + 1


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _records():
    """The registry's closed spans: name -> [span, ...]."""
    out = {}
    for s in profiling._REGISTRY.spans:
        out.setdefault(s.name, []).append(s)
    return out


@pytest.fixture
def ranges(monkeypatch):
    """The names of every ``record_function`` range entered."""
    entered = []
    real = torch.profiler.record_function

    def spy(name, args=None):
        entered.append(name)
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    return entered


def _model(rng, K=2, r=4):
    w = rng.uniform(0.05, 1.0, (F, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w ** 2, axis=0))
    cfg = DRNMFConfig(input_dim=F, r=r, output_dim=F, K_layers=K, alph=10.0,
                      lam1=0.5, params_untied=("log_D", "log_alph"),
                      params_trainable=("log_D", "log_alph"))
    return cfg, init_drnmf_params(cfg, w, device="cpu"), w


def test_off_records_nothing_and_enters_no_range(ranges):
    with _profile():
        with span("window.before"):
            pass
    assert profiling._REGISTRY.spans
    timer = StageTimer()
    with span("off", k=1) as got:
        count("off.count", 5)
        with timer.stage("off.stage"):
            pass
    assert got is None
    assert ranges == ["window.before"]
    got = tally()
    assert set(got["spans"]) == {"window.before"}
    assert got["counters"] == {}
    assert timer.seconds("off.stage") >= 0.0


def test_spans_nest_share_call_ids_and_self_time(ranges):
    with _profile():
        with span("outer", size=3):
            time.sleep(0.01)
            with span("inner"):
                time.sleep(0.02)
                with span("leaf"):
                    time.sleep(0.005)
            with span("inner"):
                count("n", 2)
                count("n", 3)
        with span("outer"):
            pass
    got = tally()
    rec = _records()
    first, second = rec["outer"]
    assert first.parent is None and second.parent is None
    assert first.call != second.call
    assert [s.parent for s in rec["inner"]] == [first, first]
    assert rec["leaf"][0].parent is rec["inner"][0]
    assert {s.call for s in rec["inner"] + rec["leaf"]} == {first.call}
    spans = got["spans"]
    assert {k: v["count"] for k, v in spans.items()} == {
        "outer": 2, "inner": 2, "leaf": 1}
    assert got["counters"] == {"n": 5}
    for row in spans.values():
        assert 0.0 <= row["host_self_s"] <= row["host_s"]
        assert row["device_s"] == pytest.approx(row["host_s"])  # the CPU
    # self = total - the children's cover
    assert spans["outer"]["host_s"] - spans["outer"]["host_self_s"] == \
        pytest.approx(spans["inner"]["host_s"], abs=1e-9)
    assert spans["inner"]["host_s"] - spans["inner"]["host_self_s"] == \
        pytest.approx(spans["leaf"]["host_s"], abs=1e-9)
    assert spans["leaf"]["host_self_s"] == spans["leaf"]["host_s"] >= 0.005
    assert spans["inner"]["host_self_s"] >= 0.015
    assert ranges == ["outer", "inner", "leaf", "inner", "outer"]


def test_covered_is_the_union_inside_the_parent():
    covered = profiling._covered
    assert covered(0, 100, []) == 0
    assert covered(0, 100, [(10, 20), (15, 30), (40, 50)]) == 30
    assert covered(20, 45, [(10, 30), (40, 60)]) == 15


@pytest.mark.parametrize("between", ["tally", "untraced_span"])
def test_each_traced_window_starts_empty(between):
    """A window ends where its tally is read or where the program records
    with tracing off (a benchmark's set-up, warm-up or untraced run)."""
    with _profile():
        with span("first"):
            count("c", 1)
    if between == "tally":
        assert "first" in tally()["spans"]
    else:
        with span("untraced"):
            pass
    with _profile():
        with span("second"):
            count("c", 2)
    got = tally()
    assert set(got["spans"]) == {"second"}
    assert got["counters"] == {"c": 2}


def test_trace_writes_only_its_block(tmp_path):
    import json

    with _profile():
        with span("before"):
            pass
    with profiling.trace(str(tmp_path), device="cpu", rank=3):
        with span("inside"):
            count("k", 4)
    with open(tmp_path / "spans_rank3.json") as fh:
        got = json.load(fh)
    assert set(got["spans"]) == {"inside"}
    assert got["counters"] == {"k": 4}
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "spans_rank3.json", "trace_rank3.json"]


def test_enhance_signals_spans_and_frame_counters(rng):
    cfg, params, _ = _model(rng)
    sigs = [(rng.standard_normal(n) * 0.2).astype(np.float32)
            for n in (300, 1500, 700, 40000, 90)]
    ref = enhance_signals(params, cfg, sigs, N_FFT, HOP, batch_size=2,
                          device="cpu")
    with _profile():
        out = enhance_signals(params, cfg, sigs, N_FFT, HOP, batch_size=2,
                              device="cpu")
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    got, rec = tally(), _records()
    per_batch = ("enhance.pad", "enhance.copy_in", "dsp.stft", "dsp.istft",
                 "enhance.copy_out", "enhance.trim")
    assert {k: v["count"] for k, v in got["spans"].items()} == {
        "enhance.call": 1, **{n: 3 for n in per_batch}}
    (call,) = rec["enhance.call"]
    for name in per_batch:
        assert all(s.call == call.call for s in rec[name])
    for name in ("enhance.pad", "enhance.copy_in", "enhance.copy_out",
                 "enhance.trim"):
        assert all(s.parent is call for s in rec[name])
    run = signal = 0
    for b0 in range(0, len(sigs), 2):
        chunk = sigs[b0:b0 + 2]
        total = max(bucket_total(len(s), N_FFT, HOP) for s in chunk)
        run += len(chunk) * (1 + (total - N_FFT) // HOP)
        signal += sum(n_frames_for_length(len(s), N_FFT, HOP) for s in chunk)
    assert got["counters"] == {"enhance.frames_run": run,
                               "enhance.frames_signal": signal}
    assert 0 < signal < run


def test_snmf_infer_irm_spans(rng):
    """One chunk: ``h`` never leaves the device, so the call records the
    mask's copy alone, and the counter holds every frame."""
    r = 4
    w = rng.uniform(0.05, 1.0, (F, 2 * r)).astype(np.float32)
    x = rng.uniform(0.0, 1.0, (F, 50)).astype(np.float32)
    params = SNMFParams(r=2 * r, sparsity=0.1, max_iter=5)
    with _profile():
        irm, h = snmf_infer_irm(x, w, params, max_iter=5, device="cpu")
    assert irm.shape == (F, 50) and h.shape == (2 * r, 50)
    got, rec = tally(), _records()
    assert {k: v["count"] for k, v in got["spans"].items()} == {
        "snmf.call": 1, "snmf.mask_to_host": 1}
    (call,) = rec["snmf.call"]
    assert rec["snmf.mask_to_host"][0].call == call.call
    assert rec["snmf.mask_to_host"][0].parent is call
    assert got["counters"] == {"snmf.h_kept_on_device": 50}


def test_snmf_infer_irm_spans_over_chunks(rng):
    """Three chunks (20 frames of 50): each chunk's ``h`` is fetched once,
    as ``snmf.h_to_host``, and its mask once; no frame counts as kept."""
    r = 4
    w = rng.uniform(0.05, 1.0, (F, 2 * r)).astype(np.float32)
    x = rng.uniform(0.0, 1.0, (F, 50)).astype(np.float32)
    params = SNMFParams(r=2 * r, sparsity=0.1, max_iter=5)
    with _profile():
        irm, h = snmf_infer_irm(x, w, params, max_iter=5, frame_chunk=20,
                                device="cpu")
    assert irm.shape == (F, 50) and h.shape == (2 * r, 50)
    got, rec = tally(), _records()
    names = ("snmf.h_to_host", "snmf.mask_to_host")
    assert {k: v["count"] for k, v in got["spans"].items()} == {
        "snmf.call": 1, **{n: 3 for n in names}}
    (call,) = rec["snmf.call"]
    for n in names:
        assert all(s.call == call.call and s.parent is call for s in rec[n])
    assert got["counters"] == {}


def test_train_step_spans(rng):
    cfg, params, _ = _model(rng, K=3)
    trains = drnmf_trainable_mask(cfg, params)
    for k, v in params.items():
        v.requires_grad_(trains[k])
    tc = loop.TrainConfig(learning_rate=1e-2, clipnorm=0.0, verbose=False)
    step = loop.make_train_step(
        lambda p, x, y, m: losses.masked_mse_signal_approx(
            drnmf_forward(p, cfg, x), x, y, m),
        loop.make_optimizer(tc, params, trains))
    x = torch.from_numpy(rng.uniform(0, 1, (3, 7, F)).astype(np.float32))
    y = x * 0.5
    mask = torch.ones((3, 7, F))
    step(params, x, y, mask)  # untraced
    with _profile():
        for _ in range(2):
            step(params, x, y, mask)
    got, rec = tally(), _records()
    assert {k: v["count"] for k, v in got["spans"].items()} == {
        "train.step": 2, "grad.residual_check": 2, "grad.weight_grads": 2}
    steps = rec["train.step"]
    assert steps[0].call != steps[1].call
    assert [s.attrs["step"] for s in steps] == [1, 2]
    for name in ("grad.residual_check", "grad.weight_grads"):
        assert [s.parent for s in rec[name]] == steps
    assert got["spans"]["train.step"]["host_self_s"] < \
        got["spans"]["train.step"]["host_s"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA timing events)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_on_the_card(cuda):
    """On the card a span's device seconds come from CUDA events: a span
    around queued products reads their device time, not the host's enqueue;
    a span opened in a backward (autograd's device thread) is recorded,
    with the span around ``backward()`` as its parent."""

    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            return a * 2

        @staticmethod
        def backward(ctx, g):
            with span("test.backward"):
                return g * 2

    a = torch.randn(4096, 4096, device=cuda)
    x = torch.ones(8, device=cuda, requires_grad=True)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        with span("test.step"):
            with span("test.products"):
                for _ in range(20):
                    a = a @ a
                    a = a / a.norm()
            Twice.apply(x).sum().backward()
        torch.cuda.synchronize()
    got, rec = tally(), _records()
    products = got["spans"]["test.products"]
    assert products["device_s"] > products["host_s"] > 0.0
    (back,) = rec["test.backward"]
    (step,) = rec["test.step"]
    assert back.parent is step and back.call == step.call
    assert got["spans"]["test.backward"]["device_s"] >= 0.0
