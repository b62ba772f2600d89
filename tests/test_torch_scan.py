"""Kernel B1's plain version and wrapper (drnmf_torch.ops.drnmf_scan)
against the TPU kernel it replaces, ``drnmf_scan_pallas_factored`` run in
interpret mode, with inputs built as tests/test_pallas_kernels.py builds
them.

Tolerance rtol 1e-5 / atol 1e-6: f32 on both sides, different summation
order in the thin products.  The CUDA kernel itself is held against the
plain version in tests/test_torch_cuda.py, which needs a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drnmf_tpu.models import DRNMFConfig, init_drnmf_params
from drnmf_tpu.models.drnmf import _effective_matrices, step_mask_from_input
from drnmf_tpu.ops.pallas import drnmf_scan_pallas_factored
from drnmf_torch.ops import drnmf_scan as tscan

TOL = dict(rtol=1e-5, atol=1e-6)


def _operands(rng, bsz, t_len, f, r, K, untie_alph=False):
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    cfg = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                      alph=10.0, lam1=0.5, untie_alph=untie_alph,
                      params_untied=("log_D", "log_alph"),
                      params_trainable=("log_D", "log_alph"),
                      matmul_precision="highest")
    params = init_drnmf_params(cfg, w)
    x = rng.uniform(0, 1, (bsz, t_len, f)).astype(np.float32)
    if bsz > 1:
        x[1, 7:] = cfg.mask_value  # one row masked after step 7
    x = jnp.asarray(x)
    sm = step_mask_from_input(x, cfg.mask_value)
    U, S, W, b = _effective_matrices(params, cfg, fold_u=True, factor_s=True)
    dkt = (jnp.stack([s[0].T for s in S]) if S
           else jnp.zeros((1, 2 * r, f), jnp.float32))
    dka = jnp.stack([W[0]] + [s[1] for s in S])
    h0 = jnp.broadcast_to(jax.nn.softplus(params["log_h0"])[None, :],
                          (bsz, 2 * r))
    return (x, sm, h0, U.diag1, U.off1, U.c, dkt, dka, jnp.stack(b))


def _to_torch(args, device="cpu"):
    return tuple(torch.from_numpy(np.array(a)).to(device) for a in args)


CASES = [  # (B, T, F, r, K)
    (3, 11, 9, 8, 3),  # the Pallas hold-out shape
    (5, 13, 9, 8, 3),  # odd B
    (3, 11, 9, 8, 1),  # K = 1 with the dummy dkT
    (4, 9, 17, 12, 5),
    (1, 5, 9, 8, 2),  # one row
    (2, 1, 9, 8, 3),  # one step
]


def test_reference_matches_pallas_factored(rng):
    for shape, untie_alph in [(c, False) for c in CASES] + [(CASES[0], True)]:
        case = "B%d_T%d_F%d_r%d_K%d" % shape + (" untied" if untie_alph else "")
        args = _operands(rng, *shape, untie_alph=untie_alph)
        ref = np.asarray(drnmf_scan_pallas_factored(*args, interpret=True))
        out = tscan.drnmf_scan_factored_reference(*_to_torch(args)).numpy()
        assert out.shape == ref.shape, case
        np.testing.assert_allclose(out, ref, err_msg=case, **TOL)


def test_wrapper_on_cpu_runs_plain_version_and_rejects_malformed(rng):
    good = _to_torch(_operands(rng, 3, 11, 9, 8, 3))
    before = tscan.LAUNCHES
    out = tscan.drnmf_scan_factored(*good)
    assert tscan.LAUNCHES == before
    np.testing.assert_array_equal(
        out.numpy(), tscan.drnmf_scan_factored_reference(*good).numpy())

    for bad in ("dtype", "contiguity", "shape", "mask_dtype", "scalar",
                "x_rank", "h0_shape"):
        args = list(good)
        if bad == "dtype":
            args[0] = args[0].double()
        elif bad == "contiguity":
            args[7] = args[7].transpose(1, 2).contiguous().transpose(1, 2)
        elif bad == "shape":
            args[6] = args[6][:, :-1]
        elif bad == "mask_dtype":
            args[1] = args[1].float()
        elif bad == "scalar":
            args[4] = 0.5
        elif bad == "x_rank":
            args[0] = args[0][0]
        else:
            args[2] = args[2][:-1]
        with pytest.raises((TypeError, ValueError)):
            tscan.drnmf_scan_factored(*args)
