"""The port's sequence- and layer-pipelined recurrences
(``drnmf_torch.parallel.seqpipe`` / ``layerpipe``) on the CPU, against the
JAX package's single-device ``_scan_hidden``.

Each test starts gloo groups of 2 or 4 ranks on the CPU
(``parallel.mesh.run_ranks``: every collective with a timeout, the join
with a deadline).  The ranks run the functions of this module, which
imports only numpy, torch and pytest at the top, so they never import JAX.
The references are the JAX package's single-device scan and ``jax.grad``
of it, never its mesh programs (ROADMAP.md, queue C, caveat 6).
Tolerances: hidden states and gradients rtol 1e-5 / atol 1e-6 (the model
tolerance; the JAX side at ``matmul_precision='highest'``), but the
gradients of the dense-U case against ``jax.grad``: rtol 2e-4, the port's
standing gradient tolerance (tests/test_torch_train.py).  That case's
recurrence amplifies (gradients up to ~4.5e3), and the port's own
single-process autograd is 1.7e-5 relative from ``jax.grad`` on a
cancelled entry there; the pipeline is held to that single process at
1e-5 / 1e-6.
"""

import numpy as np
import pytest
import torch

F, R = 9, 3
TIMEOUT_S = 60.0
TOL = dict(rtol=1e-5, atol=1e-6)
DENSE_GRAD_TOL = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def one_thread():
    """The ranks and the references on one intra-op thread each (the suite
    runs beside other test processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ranks(fn, world, *args):
    from drnmf_torch.parallel import run_ranks

    return run_ranks(fn, world, args=args, device="cpu",
                     timeout_s=TIMEOUT_S, deadline_s=2 * TIMEOUT_S)


def _model(rng, K, dense):
    """(JAX config, port config, params as numpy) of a small model; with
    ``dense`` U trains and log_U1/log_Uk are drawn so the fold does not
    hold (the cases of tests/test_parallel.py's layer-pipelined test)."""
    from drnmf_tpu.models import DRNMFConfig as JaxConfig
    from drnmf_tpu.models import init_drnmf_params
    from drnmf_torch.models.drnmf import DRNMFConfig

    kw = dict(input_dim=F, r=R, output_dim=F, K_layers=K)
    if dense:
        kw["params_trainable"] = ("log_D", "log_alph", "log_U1", "log_Uk")
    jcfg = JaxConfig(matmul_precision="highest", **kw)
    w = rng.uniform(0.05, 1.0, (F, 2 * R)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    params = {k: np.asarray(v) for k, v in init_drnmf_params(jcfg, w).items()}
    if dense:
        params["log_U1"] = rng.uniform(-3, 0, (2 * R, 2 * R)).astype(
            np.float32)
        params["log_Uk"] = rng.uniform(-6, -3, (2 * R, 2 * R)).astype(
            np.float32)
    return jcfg, DRNMFConfig(**kw), params


def _input(rng, bsz, t_len, mask_value=-1.0):
    """Frames in [0, 1) with masked tails (rows 1 and B-2 held from two
    steps before the end, row 2 from step 1 on)."""
    x = rng.uniform(0, 1, (bsz, t_len, F)).astype(np.float32)
    x[1, t_len - 2:] = mask_value
    x[bsz - 2, t_len - 2:] = mask_value
    x[2, 1:] = mask_value
    return x


def _jax_hidden(jcfg, params, x):
    import jax.numpy as jnp
    from drnmf_tpu.models.drnmf import _scan_hidden, step_mask_from_input

    xj = jnp.asarray(x)
    return np.asarray(_scan_hidden(
        params, jcfg, xj, step_mask_from_input(xj, jcfg.mask_value)))


def _step_mask(x, config):
    from drnmf_torch.models.drnmf import step_mask_from_input

    return step_mask_from_input(torch.from_numpy(x), config.mask_value)


# ---------------------------------------------------------------------------
# sequence-pipelined
# ---------------------------------------------------------------------------

def _seq_rank(rank, cases):
    from drnmf_torch.parallel import drnmf_scan_seq_pipelined, make_mesh

    mesh = make_mesh(device="cpu")
    out = []
    for tcfg, params, x, n_groups in cases:
        before = mesh.calls["world"]
        got = drnmf_scan_seq_pipelined(params, tcfg, torch.from_numpy(x),
                                       _step_mask(x, tcfg), mesh,
                                       n_groups=n_groups)
        out.append((got.numpy(), mesh.calls["world"] - before))
    return out


def test_seq_pipelined_matches_jax(rng):
    """Time split over 2 and 4 ranks, G = P and 2P groups, frozen U (the
    folded route, B1's plain version here) and dense U (B3's), masked
    tails: every rank holds the whole (B, T, 2r) output, equal to the JAX
    single-device scan; a call makes G + P - 1 shifts and one gather."""
    for n_ranks in (2, 4):
        cases, wants = [], []
        for dense in (False, True):
            jcfg, tcfg, params = _model(rng, 3, dense)
            for n_groups in (n_ranks, 2 * n_ranks):
                x = _input(rng, 8, 2 * n_ranks)
                cases.append((tcfg, params, x, n_groups))
                wants.append(_jax_hidden(jcfg, params, x))
        for rank, outs in enumerate(_ranks(_seq_rank, n_ranks, cases)):
            for (got, calls), want, case in zip(outs, wants, cases):
                msg = f"P={n_ranks} G={case[3]} rank {rank}"
                assert got.shape == want.shape, msg
                np.testing.assert_allclose(got, want, **TOL, err_msg=msg)
                assert calls == case[3] + n_ranks - 1 + 1, msg


# ---------------------------------------------------------------------------
# layer-pipelined
# ---------------------------------------------------------------------------

def _layer_rank(rank, cases):
    from drnmf_torch.parallel import drnmf_scan_layer_pipelined, make_mesh

    mesh = make_mesh(device="cpu")
    out = []
    for tcfg, params, x in cases:
        p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
        with torch.no_grad():
            inference = drnmf_scan_layer_pipelined(
                p, tcfg, torch.from_numpy(x), _step_mask(x, tcfg), mesh)
        hidden = drnmf_scan_layer_pipelined(
            p, tcfg, torch.from_numpy(x), _step_mask(x, tcfg), mesh)
        torch.mean(hidden**2).backward()
        out.append((inference.numpy(), hidden.detach().numpy(),
                    {k: None if v.grad is None else v.grad.numpy()
                     for k, v in p.items()}))
    return out


def test_layer_pipelined_matches_jax_with_gradients(rng):
    """Layer p on rank p of 4 (K = 4), folded U with factored S and dense
    U (tests/test_parallel.py:545-586's cases), masked tails: the output
    (with and without gradients) equals the JAX single-device scan on
    every rank, and the gradients of mean(h^2) equal ``jax.grad``'s (the
    dense case at DENSE_GRAD_TOL) and the port's single-process
    autograd's.  A parameter of one layer has its gradient on its owner
    alone; h0, the tied log_lam1 and dense log_Uk (read by more than one
    rank) have it, the same, on every rank."""
    import jax
    import jax.numpy as jnp
    from drnmf_tpu.models.drnmf import _scan_hidden, step_mask_from_input
    from drnmf_torch.models.drnmf import _scan_hidden as port_scan
    from drnmf_torch.parallel.layerpipe import shared_names

    cases, wants, singles = [], [], []
    for dense in (False, True):
        jcfg, tcfg, params = _model(rng, 4, dense)
        x = _input(rng, 8, 7)
        xj = jnp.asarray(x)
        sm = step_mask_from_input(xj, jcfg.mask_value)
        grads = jax.grad(lambda q: jnp.mean(
            _scan_hidden(q, jcfg, xj, sm) ** 2))(
                {k: jnp.asarray(v) for k, v in params.items()})
        cases.append((tcfg, params, x))
        wants.append((_jax_hidden(jcfg, params, x),
                      {k: np.asarray(v) for k, v in grads.items()}))
        p = {k: torch.tensor(v, requires_grad=True)
             for k, v in params.items()}
        torch.mean(port_scan(p, tcfg, torch.from_numpy(x),
                             _step_mask(x, tcfg)) ** 2).backward()
        singles.append({k: v.grad for k, v in p.items()})
    ranks = _ranks(_layer_rank, 4, cases)
    for i, ((tcfg, params, _), (want, want_g)) in enumerate(
            zip(cases, wants)):
        shared = shared_names(tcfg, folded=i == 0)
        for rank, outs in enumerate(ranks):
            inference, hidden, _ = outs[i]
            for got in (inference, hidden):
                np.testing.assert_allclose(got, want, **TOL,
                                           err_msg=f"case {i} rank {rank}")
        for k, want_k in want_g.items():
            have = [r for r, outs in enumerate(ranks)
                    if outs[i][2][k] is not None]
            if k in shared:
                assert have == [0, 1, 2, 3], (i, k, have)
            elif have:
                # one layer's parameter: on its owner only
                assert len(have) == 1, (i, k, have)
            got = (ranks[have[0]][i][2][k] if have
                   else np.zeros_like(want_k))
            for r in have:
                np.testing.assert_array_equal(ranks[r][i][2][k], got,
                                              err_msg=f"case {i} {k}")
            np.testing.assert_allclose(got, want_k,
                                       **(DENSE_GRAD_TOL if i else TOL),
                                       err_msg=f"case {i} grad {k}")
            single = singles[i][k]
            np.testing.assert_allclose(
                got, np.zeros_like(got) if single is None else single,
                **TOL, err_msg=f"case {i} grad {k} against one process")


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _refusal_rank(rank, cases):
    from drnmf_torch.parallel import (drnmf_scan_layer_pipelined,
                                      drnmf_scan_seq_pipelined, make_mesh)

    mesh = make_mesh(device="cpu")
    fns = {"seq": drnmf_scan_seq_pipelined,
           "layer": drnmf_scan_layer_pipelined}
    out = []
    for which, tcfg, params, x, kw in cases:
        try:
            fns[which](params, tcfg, torch.from_numpy(x),
                       _step_mask(x, tcfg), mesh, **kw)
            out.append(None)
        except (ValueError, NotImplementedError) as e:
            out.append((type(e).__name__, str(e)))
    return out


def test_pipelined_scans_refuse(rng):
    """The JAX functions' refusals (seqpipe.py:59-70, layerpipe.py:53-68),
    raised on every rank of 4 before any collective: K != P, T or B not
    divisible, dropout, return_all_hidden, no input to the layers; K = 1
    on one process (``Mesh.local``)."""
    import dataclasses

    from drnmf_torch.parallel import Mesh, drnmf_scan_layer_pipelined

    _, tcfg, params = _model(rng, 4, False)
    x = _input(rng, 8, 8)
    cases = [
        ("layer", dataclasses.replace(tcfg, K_layers=2), params, x, {},
         "must equal the pp axis size 4"),
        ("layer", tcfg, params, x[:6], {}, "B=6 not divisible by pp=4"),
        ("layer", dataclasses.replace(tcfg, dropout_U=0.1), params, x, {},
         "plain cell only"),
        ("layer", dataclasses.replace(tcfg, return_all_hidden=True), params,
         x, {}, "plain cell only"),
        ("layer", dataclasses.replace(tcfg, connect_input_to_layers=False),
         params, x, {}, "requires connect_input_to_layers"),
        ("seq", tcfg, params, x[:, :7], {}, "T=7 not divisible by sp=4"),
        ("seq", tcfg, params, x[:6], {}, "B=6 not divisible by n_groups=4"),
        ("seq", tcfg, params, x, {"n_groups": 3},
         "B=8 not divisible by n_groups=3"),
        ("seq", dataclasses.replace(tcfg, dropout_W=0.2), params, x, {},
         "inference cell only"),
    ]
    for rank, outs in enumerate(_ranks(_refusal_rank, 4,
                                       [c[:5] for c in cases])):
        for got, case in zip(outs, cases):
            assert got is not None and case[5] in got[1], (rank, case[5],
                                                           got)
    _, k1, p1 = _model(rng, 1, False)
    with pytest.raises(ValueError, match="K_layers >= 2"):
        drnmf_scan_layer_pipelined(p1, k1, torch.from_numpy(x),
                                   _step_mask(x, k1), Mesh.local("cpu"))
