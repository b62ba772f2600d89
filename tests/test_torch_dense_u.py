"""DR-NMF with a trained, dense U (``log_U1``/``log_Uk`` trainable) on the
port's offline path, on the CPU at a tiny size: ``enhance_signals`` agrees
with the benchmark's plain reference (``benchmark/reference``) on seeded
random weights and the benchmark's kind of U draw; that U breaks the
fold's structure and routes the recurrence to ``drnmf_scan_dense`` (B3 on
the card) once a batch, never to ``drnmf_scan_factored``, which the
counter ``scan.dense_row_steps`` and the span ``drnmf.dense_weights`` show
under a profiler session; and zeroing U's off-diagonal moves the waveforms
past the benchmark's tiny limit."""

import numpy as np
import pytest
import torch

from benchmark.reference import drnmf as ref_drnmf
from benchmark.reference import dsp as ref_dsp
from benchmark.reference.drnmf_dense import draw_log_u
from benchmark.tests.tiny import LIMITS, TINY_DRNMF
from benchmark.yardstick.compare import waveform_gap
from benchmark.yardstick.corpus import dictionary, frames_of
from drnmf_torch import enhance
from drnmf_torch.config import drnmf_config_from_params
from drnmf_torch.convert import init_drnmf_params
from drnmf_torch.models import drnmf
from drnmf_torch.ops.drnmf_scan import LAUNCHES
from drnmf_torch.utils.profiling import tally

N_FFT, HOP = TINY_DRNMF["n_fft"], TINY_DRNMF["hop"]
F = N_FFT // 2 + 1
LIMIT = LIMITS["offline"]["wave_rel_l2"]  # the tiny cells' limit
U_SEED = 2 ** 40 + 11


def _config(k_layers=3):
    # the flagship's draw at 2r = 16: uniform(0, 0.05 / 2r) added, as
    # 2.5e-5 is at 2r = 2000
    return dict(TINY_DRNMF, K_layers=k_layers,
                params_trainable=["log_D", "log_alph", "log_U1", "log_Uk"],
                u_draw={"log_U1_shift": 0.2, "log_Uk_shift": 0.5,
                        "added": 0.05 / 16})


def _model(config, seed=5, draw=True):
    """(program config, program params, reference params): the same
    dictionary, initial state and (with ``draw``) drawn U on both
    sides."""
    cfg = drnmf_config_from_params(config, F, config["mask_value"])
    w = dictionary(torch.Generator().manual_seed(seed), F, cfg.hidden_dim,
                   "cpu", config["dictionary_power"])
    u_h0 = torch.rand((cfg.hidden_dim,),
                      generator=torch.Generator().manual_seed(seed + 1))
    prog = init_drnmf_params(cfg, w.numpy(),
                             generator=torch.Generator().manual_seed(seed + 1),
                             device="cpu")
    ref = ref_drnmf.init_params(config, w, u_h0)
    for params in (prog, ref) if draw else ():
        params["log_U1"], params["log_Uk"] = draw_log_u(config, U_SEED)
    return cfg, prog, ref


def _signals(n=5, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.5, 0.5, int(m)).astype(np.float32)
            for m in rng.integers(100, 400, n)]


def _reference_waves(ref, config, signals):
    spec = ref_dsp.stft(signals, N_FFT, HOP, "cpu")
    irm = ref_drnmf.ratio_mask(ref, config, spec.abs())
    wav = ref_dsp.istft(spec * irm, N_FFT, HOP).numpy()
    return [wav[j, :len(s)] for j, s in enumerate(signals)]


@pytest.mark.parametrize("k_layers", [1, 3])
def test_dense_route_agrees_with_the_reference(k_layers):
    config = _config(k_layers)
    cfg, prog, ref = _model(config)
    signals = _signals()
    got = enhance.enhance_signals(prog, cfg, signals, N_FFT, HOP,
                                  batch_size=3, device="cpu")
    with torch.no_grad():
        want = _reference_waves(ref, config, signals)
    assert waveform_gap(got, want) <= LIMIT


def test_drawn_u_routes_to_the_dense_scan(monkeypatch):
    config = _config()
    cfg, prog, _ = _model(config)
    assert not drnmf.fold_structure_holds(prog)
    assert not drnmf.u_is_foldable(cfg)
    calls = {"dense": [], "factored": 0}
    dense, factored = drnmf.drnmf_scan_dense, drnmf.drnmf_scan_factored

    def spy_dense(x, *args):
        calls["dense"].append(tuple(x.shape[:2]))
        return dense(x, *args)

    def spy_factored(*args):
        calls["factored"] += 1
        return factored(*args)

    monkeypatch.setattr(drnmf, "drnmf_scan_dense", spy_dense)
    monkeypatch.setattr(drnmf, "drnmf_scan_factored", spy_factored)
    before = dict(LAUNCHES)
    signals = _signals(n=5)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        enhance.enhance_signals(prog, cfg, signals, N_FFT, HOP,
                                batch_size=2, device="cpu")
    got = tally()
    # one scan a batch of 2, 2 and 1 rows, each over its bucket's frames
    assert [b for b, _ in calls["dense"]] == [2, 2, 1]
    assert calls["factored"] == 0
    assert LAUNCHES == before  # no kernel on the CPU, no time loop
    assert got["counters"]["scan.dense_row_steps"] == sum(
        b * t for b, t in calls["dense"])
    assert got["spans"]["drnmf.dense_weights"]["count"] == 3
    # the CPU runs the plain version: no scratch is staged
    assert "scan.dense_stage" not in got["spans"]


def test_factored_route_records_nothing_new():
    cfg, prog, _ = _model(dict(TINY_DRNMF), draw=False)
    assert drnmf.fold_structure_holds(prog) and drnmf.u_is_foldable(cfg)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        enhance.enhance_signals(prog, cfg, _signals(n=2), N_FFT, HOP,
                                device="cpu")
    got = tally()
    assert "enhance.call" in got["spans"]
    assert "drnmf.dense_weights" not in got["spans"]
    assert "scan.dense_row_steps" not in got["counters"]


def test_zeroing_the_off_diagonal_of_u_is_seen():
    """The drawn U's off-diagonal mass is what the dense model adds to the
    folded one: without it the waveforms leave the limit."""
    config = _config()
    cfg, prog, ref = _model(config)
    signals = _signals()
    eye = torch.eye(cfg.hidden_dim, dtype=torch.bool)
    zeroed = dict(prog)
    for name in ("log_U1", "log_Uk"):
        zeroed[name] = torch.where(eye, prog[name], -torch.inf)
    got = enhance.enhance_signals(zeroed, cfg, signals, N_FFT, HOP,
                                  device="cpu")
    with torch.no_grad():
        want = _reference_waves(ref, config, signals)
    assert waveform_gap(got, want) > 10 * LIMIT
    frames = frames_of([len(s) for s in signals], N_FFT, HOP)
    assert frames.min() > 10  # every signal runs the recurrence a while
