"""Kernel B1 and the enhancer on the card, against their plain versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports neither jax nor drnmf_tpu, so on a machine with a
card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance rtol 1e-4 / atol 1e-5 on hidden states: f32 on both sides, the
kernel summing the thin products in another order than cuBLAS.  One test
walks every case and names it in a failure message.
"""

import numpy as np
import pytest
import torch

from drnmf_torch.convert import init_drnmf_params
from drnmf_torch.enhance import enhance_signals
from drnmf_torch.models import drnmf
from drnmf_torch.ops import drnmf_scan

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel B1 has no CPU mode)")
    return torch.device("cuda")


def _model(seed, f, r, K, device, **overrides):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    cfg = drnmf.DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                            alph=10.0, lam1=0.5, **overrides)
    params = init_drnmf_params(cfg, w,
                               generator=torch.Generator().manual_seed(seed),
                               device=device)
    return cfg, params, rng


SHAPES = [  # (B, T, F, r)
    (1, 1, 9, 8),  # one row, one step
    (1, 11, 9, 8),
    (2, 11, 9, 8),
    (3, 11, 9, 8),  # the Pallas hold-out shape, one row masked
    (5, 13, 9, 8),  # odd B: the last block has a row past the batch
    (4, 9, 17, 12),
    (3, 7, 33, 7),  # odd 2r
    (6, 4, 65, 100),
    (9, 5, 129, 64),
    (33, 3, 257, 50),
    (7, 6, 257, 1000),  # flagship widths
    (256, 3, 257, 1000),  # flagship batch
]


def _kernel_matches_plain_version(device):
    for shape in SHAPES:
        for K in (1, 2, 3, 5):
            for untie_alph in (False, True):
                case = "B%d_T%d_F%d_r%d" % shape + f" K={K} untied={untie_alph}"
                bsz, t_len, f, r = shape
                cfg, params, rng = _model(0, f, r, K, device,
                                          untie_alph=untie_alph)
                x = rng.uniform(0, 1, (bsz, t_len, f)).astype(np.float32)
                # a row held from step 7
                x[bsz // 2, min(7, t_len - 1):] = cfg.mask_value
                x = torch.from_numpy(x).to(device)
                args = drnmf.factored_scan_operands(
                    params, cfg, x,
                    drnmf.step_mask_from_input(x, cfg.mask_value))
                before = drnmf_scan.LAUNCHES
                out = drnmf_scan.drnmf_scan_factored(*args)
                torch.cuda.synchronize()
                assert drnmf_scan.LAUNCHES == before + 1, case
                ref = drnmf_scan.drnmf_scan_factored_reference(*args)
                np.testing.assert_allclose(out.cpu().numpy(),
                                           ref.cpu().numpy(), err_msg=case,
                                           **TOL)


def _wrapper_rejects_malformed_operands(device):
    cfg, params, rng = _model(1, 9, 8, 3, device)
    x = torch.from_numpy(rng.uniform(0, 1, (3, 5, 9)).astype(np.float32))
    x = x.to(device)
    good = drnmf.factored_scan_operands(
        params, cfg, x, drnmf.step_mask_from_input(x, cfg.mask_value))
    for bad in ("dtype", "contiguity", "shape", "mask_dtype", "device"):
        args = list(good)
        if bad == "dtype":
            args[0] = args[0].double()
        elif bad == "contiguity":
            args[0] = x.transpose(0, 1).contiguous().transpose(0, 1)
        elif bad == "shape":
            args[6] = args[6][:, :-1]
        elif bad == "mask_dtype":
            args[1] = args[1].float()
        else:
            args[2] = args[2].cpu()
        before = drnmf_scan.LAUNCHES
        with pytest.raises((TypeError, ValueError)):
            drnmf_scan.drnmf_scan_factored(*args)
        assert drnmf_scan.LAUNCHES == before, bad


def _enhance_matches_cpu(device):
    """enhance_signals on the card (B1) against the same call on the CPU
    (plain version): waveforms within rtol 1e-4 / atol 1e-5."""
    for n_fft, hop in ((256, 64), (512, 128)):
        for K in (1, 2):
            cfg, params, rng = _model(2, n_fft // 2 + 1, 8, K, device)
            sigs = [(rng.standard_normal(n) * 0.2).astype(np.float32)
                    for n in (2000, 3500, 2999)]
            before = drnmf_scan.LAUNCHES
            on_card = enhance_signals(params, cfg, sigs, n_fft, hop,
                                      batch_size=2)
            assert drnmf_scan.LAUNCHES == before + 2
            on_cpu = enhance_signals({k: v.cpu() for k, v in params.items()},
                                     cfg, sigs, n_fft, hop, batch_size=2,
                                     device="cpu")
            for a, b in zip(on_card, on_cpu):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                           err_msg=f"{n_fft}/{hop} K={K}")


def _other_configs_run_plain_loop(device):
    """Configurations B1 does not compute run the plain time loop on the
    card, launch no kernel, and agree with the CPU."""
    for overrides in (
            dict(activation="tanh"), dict(factored_S=False),
            dict(params_trainable=("log_D", "log_alph", "log_U1", "log_Uk")),
            dict(return_all_hidden=True), dict(connect_input_to_layers=False)):
        cfg, params, rng = _model(3, 17, 12, 3, device, **overrides)
        x = torch.from_numpy(rng.uniform(0, 1, (3, 9, 17)).astype(np.float32))
        before = drnmf_scan.LAUNCHES
        on_card = drnmf.drnmf_forward(params, cfg, x.to(device),
                                      return_parts=True)
        torch.cuda.synchronize()
        assert drnmf_scan.LAUNCHES == before, overrides
        on_cpu = drnmf.drnmf_forward({k: v.cpu() for k, v in params.items()},
                                     cfg, x, return_parts=True)
        for a, b in zip(on_card, on_cpu):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(),
                                       err_msg=str(overrides), **TOL)


@pytest.mark.cuda
def test_on_card(cuda):
    """B1 against its plain version over a grid of shapes (one row, one
    step, odd B and 2r, K = 1 with the dummy dkT, the flagship widths and
    batch; tied and untied alph); the wrapper's checks; the enhancer on the
    card against the CPU; and the configurations that stay off B1."""
    _kernel_matches_plain_version(cuda)
    _wrapper_rejects_malformed_operands(cuda)
    _enhance_matches_cpu(cuda)
    _other_configs_run_plain_loop(cuda)
