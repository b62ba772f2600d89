"""The plain reference agrees with drnmf_torch on the CPU at a tiny size
(the reference imports nothing of the program; this test imports both)."""

import numpy as np
import pytest
import torch

from benchmark.reference import drnmf as ref_drnmf
from benchmark.reference import dsp as ref_dsp
from benchmark.reference import snmf as ref_snmf
from benchmark.reference.precision import mm, tf32_round
from benchmark.tests.tiny import TINY_DRNMF, TINY_SNMF
from benchmark.yardstick.corpus import dictionary
from drnmf_torch.config import (drnmf_config_from_params,
                                snmf_params_from_config)
from drnmf_torch.convert import init_drnmf_params
from drnmf_torch.dsp.stft import istft, stft
from drnmf_torch.models.drnmf import drnmf_forward, drnmf_trainable_mask
from drnmf_torch.models.snmf_enhancer import snmf_infer_irm
from drnmf_torch.train import loop, losses


def _model(seed=3):
    cfg = drnmf_config_from_params(TINY_DRNMF, 17, -1.0)
    w = dictionary(torch.Generator().manual_seed(seed), 17, cfg.hidden_dim,
                   "cpu", 16)
    u = torch.rand((cfg.hidden_dim,),
                   generator=torch.Generator().manual_seed(seed + 1))
    prog = init_drnmf_params(cfg, w.numpy(),
                             generator=torch.Generator().manual_seed(seed + 1),
                             device="cpu")
    return cfg, prog, ref_drnmf.init_params(TINY_DRNMF, w, u), w


def test_parameters_agree():
    _, prog, ref, _ = _model()
    assert set(prog) == set(ref)
    for k in prog:
        torch.testing.assert_close(ref[k], prog[k], rtol=1e-6, atol=1e-6)


def test_stft_and_istft_agree():
    gen = torch.Generator().manual_seed(1)
    signals = [torch.randn(n, generator=gen).numpy() for n in (100, 173)]
    spec = ref_dsp.stft(signals, 32, 8, "cpu")
    for j, s in enumerate(signals):
        want = stft(torch.from_numpy(s), 32, 8)
        n = ref_dsp.n_frames(len(s), 32, 8)
        assert want.shape[0] == n
        torch.testing.assert_close(spec[j, :n], want, rtol=1e-5, atol=1e-5)
        back = ref_dsp.istft(spec[j:j + 1, :n], 32, 8)[0]
        torch.testing.assert_close(back, istft(want, 32, 8), rtol=1e-5,
                                   atol=1e-6)


def test_drnmf_mask_agrees():
    cfg, prog, ref, _ = _model()
    x = torch.rand((3, 40, 17), generator=torch.Generator().manual_seed(2))
    x[1, 25:] = -1.0  # a masked tail
    with torch.no_grad():
        want = drnmf_forward(prog, cfg, x)
        got = ref_drnmf.ratio_mask(ref, TINY_DRNMF, x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_train_steps_agree_with_the_program_step():
    cfg, prog, ref, _ = _model()
    gen = torch.Generator().manual_seed(5)
    batches = []
    for _ in range(3):
        x = torch.rand((4, 12, 17), generator=gen)
        y = x * torch.rand((4, 12, 17), generator=gen)
        m = torch.ones((4, 12, 1))
        x[2, 8:], y[2, 8:], m[2, 8:] = -1.0, -1.0, 0.0
        batches.append((x, y, m))
    trains = drnmf_trainable_mask(cfg, prog)
    names = sorted(k for k, t in trains.items() if t)
    start = {k: prog[k].clone() for k in names}
    opt = loop.make_optimizer(loop.TrainConfig(learning_rate=0.01), prog,
                              trains)
    for k in names:
        prog[k].requires_grad_(True)

    def loss_fn(p, x, y, m):
        return losses.masked_mse_signal_approx(drnmf_forward(p, cfg, x), x,
                                               y, m)

    step = loop.make_train_step(loss_fn, opt)
    got_losses, first = [], None
    for i, batch in enumerate(batches):
        got_losses.append(float(step(prog, *batch)))
        if i == 0:
            first = {k: float((m / 0.1).norm())
                     for k, m in zip(opt.names, opt.mu)}
    got_change = {k: float((prog[k].detach() - start[k]).norm())
                  for k in names}
    w_losses, w_first, w_change = ref_drnmf.train_steps(
        ref, names, TINY_DRNMF, batches, 0.01)
    np.testing.assert_allclose(got_losses, w_losses, rtol=1e-5)
    for k in names:
        assert first[k] == pytest.approx(w_first[k], rel=1e-4, abs=1e-9)
        assert got_change[k] == pytest.approx(w_change[k], rel=1e-4,
                                              abs=1e-9)


def test_snmf_inference_agrees():
    params = snmf_params_from_config(TINY_SNMF)
    w = dictionary(torch.Generator().manual_seed(4), 17, 12, "cpu", 16)
    v = torch.rand((17, 30), generator=torch.Generator().manual_seed(6))
    irm, h = snmf_infer_irm(v, w.numpy(), params, max_iter=30,
                            device="cpu")
    h0 = torch.rand((12, 30), generator=torch.Generator().manual_seed(
        params.random_seed))
    h_ref = ref_snmf.infer(v, w, h0, params.sparsity, 30)
    np.testing.assert_allclose(h_ref.numpy(), h, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(ref_snmf.ratio_mask(w, h_ref).numpy(), irm,
                               rtol=1e-4, atol=1e-7)


def test_tf32_product_rounds_its_operands():
    a = torch.tensor([[1.0 + 2 ** -12]])
    assert float(tf32_round(a)) == 1.0
    assert float(tf32_round(torch.tensor([1.0 + 2 ** -10]))) == 1.0 + 2 ** -10
    b = torch.tensor([[3.0]])
    assert float(mm(a, b, "tf32")) == 3.0
    assert float(mm(a, b)) == pytest.approx(3.0 * (1 + 2 ** -12))
    a.requires_grad_(True)
    (mm(a, b, "tf32") * 1.0).sum().backward()
    assert float(a.grad) == 3.0
