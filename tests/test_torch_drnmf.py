"""The port's DR-NMF model (drnmf_torch.models.drnmf) against the JAX
package's, on the CPU, with the same parameters handed across as numpy.

Tolerance rtol 1e-5 / atol 1e-6 on hidden states, head outputs and masks:
both sides compute in f32 (JAX at matmul_precision='highest') in a different
summation order, which moves a small model's states by about 1e-7.
Each test loops over its cases and names the case in a failure message."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch
import yaml

from drnmf_tpu.models import DRNMFConfig as JaxConfig
from drnmf_tpu.models import drnmf as jdrnmf
from drnmf_tpu.models import init_drnmf_params as jax_init
from drnmf_tpu.pipeline import drnmf_config_from_params as jax_config_from
from drnmf_torch import config as tconfig
from drnmf_torch.convert import init_drnmf_params, params_from_numpy
from drnmf_torch.models import drnmf as tdrnmf

TOL = dict(rtol=1e-5, atol=1e-6)
F, R, T = 33, 16, 20

# name -> (config overrides, perturb U so the fold's structure breaks)
CASES = {
    "folded_factored_K1": (dict(K_layers=1), False),
    "folded_factored_K3": (dict(), False),
    "dense_S": (dict(factored_S=False), False),
    "U_trainable": (dict(params_trainable=("log_D", "log_alph", "log_U1",
                                           "log_Uk")), False),
    "U_broken_structure": (dict(), True),
    "tanh": (dict(activation="tanh"), False),
    "no_input_to_layers": (dict(connect_input_to_layers=False), False),
    "return_all_hidden": (dict(return_all_hidden=True), False),
    "not_nonnegative": (dict(nonnegative=False), False),
    "untie_alph": (dict(untie_alph=True), False),
    "square": (dict(transform_before_irm="square"), False),
    "sigmoid": (dict(activation="sigmoid"), False),
    "linear": (dict(activation="linear"), False),
    "tied_params": (dict(params_untied=(), params_trainable=("log_D",)), False),
    "folded_factored_K5": (dict(K_layers=5), False),
}


def _model(rng, overrides, break_u):
    kw = dict(input_dim=F, r=R, output_dim=F, K_layers=3, alph=10.0,
              lam1=0.5, params_untied=("log_D", "log_alph"),
              params_trainable=("log_D", "log_alph"))
    kw.update(overrides)
    jcfg = JaxConfig(matmul_precision="highest", **kw)
    tcfg = tdrnmf.DRNMFConfig(**kw)
    w = rng.uniform(0.05, 1.0, (F, 2 * R)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    params = {k: np.asarray(v) for k, v in jax_init(jcfg, w).items()}
    if break_u:
        params["log_U1"] = params["log_U1"].copy()
        params["log_U1"][0, 1] += 0.5
        jcfg = jdrnmf.ensure_fold_valid(jcfg, params, verbose=False)
        tcfg = tdrnmf.ensure_fold_valid(tcfg, params, verbose=False)
        assert not jcfg.fold_frozen_U and not tcfg.fold_frozen_U
    return jcfg, tcfg, params


def _input(rng):
    x = rng.uniform(0.0, 1.0, (3, T, F)).astype(np.float32)
    x[1, 7:] = -1.0  # masked tail: the state holds
    x[2, 3] = -1.0  # one masked step mid-sequence
    return x


def test_forward_matches_jax_for_every_flag(rng):
    for case in sorted(CASES):
        jcfg, tcfg, params = _model(rng, *CASES[case])
        x = _input(rng)
        ref = [np.asarray(a) for a in jdrnmf.drnmf_forward(
            params, jcfg, jnp.asarray(x), return_parts=True)]
        tparams = params_from_numpy(params, "cpu")
        out = [a.numpy() for a in tdrnmf.drnmf_forward(
            tparams, tcfg, torch.from_numpy(x), return_parts=True)]
        for name, o, r in zip(("irm", "hidden", "clean", "noise"), out, ref):
            assert o.shape == r.shape, (case, name)
            np.testing.assert_allclose(o, r, err_msg=f"{case}: {name}", **TOL)
        irm = tdrnmf.drnmf_forward(tparams, tcfg, torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(irm, out[0], err_msg=case)


def test_init_convert_and_config_match_jax(rng, tmp_path):
    for overrides in (dict(), dict(untie_alph=True, params_untied=("log_D",)),
                      dict(nonnegative=False)):
        kw = dict(input_dim=F, r=R, output_dim=F, K_layers=3, alph=10.0,
                  lam1=0.5, params_untied=("log_D", "log_alph"))
        kw.update(overrides)
        w = rng.uniform(0.05, 1.0, (F, 2 * R)).astype(np.float32)
        w /= np.sqrt(np.sum(w**2, axis=0))
        ref = jax_init(JaxConfig(**kw), w)
        ours = init_drnmf_params(tdrnmf.DRNMFConfig(**kw), w, device="cpu")
        assert set(ours) == set(ref), overrides
        for k in ref:
            assert ours[k].dtype == torch.float32
            if k == "log_h0":  # drawn from the torch.Generator instead
                h0 = ours[k].numpy()
                assert h0.shape == (2 * R,)
                assert np.all(np.abs(h0) <= 0.05)
                continue
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]),
                                          err_msg=f"{overrides}: {k}")
        if "log_h0" in ours:
            again = init_drnmf_params(
                tdrnmf.DRNMFConfig(**kw), w,
                generator=torch.Generator().manual_seed(7654), device="cpu")
            np.testing.assert_array_equal(again["log_h0"].numpy(),
                                          ours["log_h0"].numpy())

    # params_from_numpy copies: a read-only array stays untouched
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    a.setflags(write=False)
    out = params_from_numpy({"a": a}, "cpu")["a"]
    out += 1
    np.testing.assert_array_equal(a, np.arange(6).reshape(2, 3))

    # YAML -> config: same fields as the JAX mapping; TPU knobs ignored
    model = {"K_layers": 5, "r": 100, "alph": 400.0, "lam1": 1.0,
             "params_untied": ["log_D", "log_alph"],
             "params_trainable": ["log_D", "log_alph"],
             "untie_alph": True, "transform_before_irm": "square",
             "matmul_precision": "highest", "fold_frozen_U": False,
             "use_pallas": True, "remat": False, "remat_policy": "dots",
             "scan_unroll": 8, "batched_grad": True}
    path = tmp_path / "params_unfolded_snmf_x.yaml"
    path.write_text(yaml.safe_dump(model))
    ours = tconfig.drnmf_config_from_params(tconfig.load_yaml(str(path)), 257)
    theirs = jax_config_from(model, 257)
    for field in dataclasses.fields(ours):
        assert getattr(ours, field.name) == getattr(theirs, field.name), (
            field.name)
    assert not hasattr(ours, "use_pallas")


def test_cell_step_module_and_fold_checks_match_jax(rng):
    h = rng.uniform(0.0, 0.5, (3, 2 * R)).astype(np.float32)
    x_t = rng.uniform(0.0, 1.0, (3, F)).astype(np.float32)
    for case in ("folded_factored_K3", "U_trainable", "tanh", "dense_S",
                 "no_input_to_layers", "not_nonnegative"):
        jcfg, tcfg, params = _model(rng, *CASES[case])
        jstep = jdrnmf.make_cell_step(jcfg, *jdrnmf._effective_matrices(
            params, jcfg, fold_u=True, factor_s=True))
        tparams = params_from_numpy(params, "cpu")
        tstep = tdrnmf.make_cell_step(
            tcfg, *tdrnmf._effective_matrices(tparams, tcfg))
        np.testing.assert_allclose(
            tstep(torch.from_numpy(h), torch.from_numpy(x_t)).numpy(),
            np.asarray(jstep(jnp.asarray(h), jnp.asarray(x_t))),
            err_msg=case, **TOL)

    jcfg, tcfg, params = _model(rng, {}, False)
    tparams = params_from_numpy(params, "cpu")
    x = torch.from_numpy(_input(rng))
    model = tdrnmf.DRNMF(tcfg, tparams)
    assert not any(p.requires_grad for p in model.parameters())
    np.testing.assert_array_equal(
        model(x).numpy(), tdrnmf.drnmf_forward(tparams, tcfg, x).numpy())

    assert tdrnmf.fold_structure_holds(tparams)
    assert tdrnmf.fold_structure_holds(params) == jdrnmf.fold_structure_holds(
        params)
    assert tdrnmf.u_is_foldable(tcfg) == jdrnmf.u_is_foldable(jcfg)
    assert tdrnmf.ensure_fold_valid(tcfg, tparams, verbose=False) is tcfg
    tparams["log_Uk"][3, 4] += 1.0
    assert not tdrnmf.fold_structure_holds(tparams)
