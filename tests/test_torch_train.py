"""Training in the port (drnmf_torch.train, the model's training side,
the batched-T backward) against the JAX package's, on the CPU.

The same inputs and parameters (the JAX package's initial values, handed
across as numpy) go through both packages; JAX runs at
``matmul_precision='highest'`` on the CPU, the port with ``device='cpu'``
on its kernels' plain versions.  Tolerances: losses rtol 1e-6 (the same
f32 sums in another order); dropout forward rtol 1e-5 / atol 1e-6 (the
model tests' tolerance); gradients rtol 2e-4 / atol 1e-6 (the JAX package's
own batched-against-autodiff tolerance: long chains of f32 products summed
in another order); the Function's plain backward against autograd through
the port's own time loop rtol 1e-5; three Adam steps rtol 1e-4 on losses
and rtol 1e-4 / atol 1e-6 on parameters (no entry there has a gradient
zero within rounding, which Adam would move by up to lr a step: the test
checks); a fit's history rtol 1e-4, its parameters rtol 1e-4 / atol 1e-4
of lr a step; a resumed fit against the uninterrupted one exactly.  Each
test walks its cases and names them in a failure message.
"""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drnmf_tpu.models import DRNMFConfig as JaxConfig
from drnmf_tpu.models import drnmf as jdrnmf
from drnmf_tpu.models import init_drnmf_params as jax_init
from drnmf_tpu.train import checkpoint as jcheckpoint
from drnmf_tpu.train import loop as jloop
from drnmf_tpu.train import losses as jlosses
from drnmf_torch.convert import params_from_numpy
from drnmf_torch.models import batched_grad
from drnmf_torch.models import drnmf as tdrnmf
from drnmf_torch.ops import drnmf_scan
from drnmf_torch.train import history as thistory
from drnmf_torch.train import loop as tloop
from drnmf_torch.train import losses as tlosses

F, R, B, T = 9, 4, 3, 7
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)


def _configs(K=2, r=R, **overrides):
    kw = dict(input_dim=F, r=r, output_dim=F, K_layers=K, alph=10.0,
              lam1=0.5, params_untied=("log_D", "log_alph"),
              params_trainable=("log_D", "log_alph"))
    kw.update(overrides)
    return (JaxConfig(matmul_precision="highest", **kw),
            tdrnmf.DRNMFConfig(**kw))


def _params(rng, jcfg, r=R):
    w = rng.uniform(0.05, 1.0, (F, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    return {k: np.asarray(v) for k, v in jax_init(jcfg, w).items()}


def _data(rng, n=B, t=T, mask_value=-1.0):
    """(x, y, mask (n, t, 1)): masked tails on two rows, one masked step
    mid-sequence."""
    y = rng.uniform(0.0, 1.0, (n, t, F)).astype(np.float32)
    x = y + rng.uniform(0.0, 1.0, (n, t, F)).astype(np.float32)
    mask = np.ones((n, t, 1), np.float32)
    for row, start, stop in ((1, 5, t), (2, 3, t), (0, 2, 3)):
        if row < n:
            mask[row, start:stop] = 0
            x[row, start:stop] = mask_value
            y[row, start:stop] = mask_value
    return x, y, mask


def _trainable(tparams, trains):
    for k, v in tparams.items():
        v.requires_grad_(trains[k])
    return tparams


def test_losses_match_jax(rng):
    irm = rng.uniform(0, 1, (B, T, F)).astype(np.float32)
    clean = rng.uniform(0, 1, (B, T, F)).astype(np.float32)
    noise = rng.uniform(0, 1, (B, T, F)).astype(np.float32)
    hidden = rng.normal(0, 1, (B, T, 2 * R)).astype(np.float32)
    x, y, mask3 = _data(rng)
    for name, mask in (("2-D", mask3[..., 0]), ("3-D", mask3),
                       ("all zero", np.zeros_like(mask3))):
        j = [jnp.asarray(a) for a in (irm, x, y, mask, clean, noise, hidden)]
        t = [torch.from_numpy(a) for a in (irm, x, y, mask, clean, noise,
                                           hidden)]
        np.testing.assert_allclose(
            float(tlosses.masked_mse_signal_approx(*t[:4])),
            float(jlosses.masked_mse_signal_approx(*j[:4])), rtol=1e-6,
            err_msg=name)
        np.testing.assert_allclose(
            float(tlosses.snmf_pretrain_loss(t[4], t[5], t[6], t[1], t[3],
                                             0.3)),
            float(jlosses.snmf_pretrain_loss(j[4], j[5], j[6], j[1], j[3],
                                             0.3)), rtol=1e-6, err_msg=name)
    assert float(tlosses.masked_mse_signal_approx(
        *t[:3], torch.zeros((B, T)))) == 0.0


def test_model_training_side_matches_jax(rng):
    # which parameters train
    for untied in ((), ("log_D", "log_alph")):
        for nonnegative in (True, False):
            for trainable in (("log_D",), ("log_D", "log_alph", "log_lam1"),
                              ("log_D", "log_U1")):
                jcfg, tcfg = _configs(params_untied=untied,
                                      params_trainable=trainable,
                                      nonnegative=nonnegative)
                params = _params(rng, jcfg)
                assert tdrnmf.drnmf_trainable_mask(tcfg, params) == \
                    jdrnmf.drnmf_trainable_mask(jcfg, params), (
                        untied, nonnegative, trainable)

    # variational dropout, the JAX package's masks handed across
    x, _, _ = _data(rng)
    for K, rates in ((1, (0.5, 0.0)), (2, (0.5, 0.5)), (3, (0.0, 0.3))):
        jcfg, tcfg = _configs(K=K, dropout_U=rates[0], dropout_W=rates[1])
        params = _params(rng, jcfg)
        key = jax.random.PRNGKey(K)
        ku, kw = jax.random.split(key)
        masks = tuple(
            None if rate == 0 else torch.from_numpy(np.array(
                jdrnmf._dropout_mask(k, shape, rate)))
            for k, shape, rate in ((ku, (B, 2 * R), rates[0]),
                                   (kw, (B, F), rates[1])))
        ref = np.asarray(jdrnmf.drnmf_apply(params, jcfg, jnp.asarray(x),
                                            rng=key, training=True))
        tparams = params_from_numpy(params, "cpu")
        xt = torch.from_numpy(x)
        before = dict(drnmf_scan.LAUNCHES)
        got = tdrnmf.drnmf_forward(tparams, tcfg, xt, training=True,
                                   dropout=masks)
        assert drnmf_scan.LAUNCHES == {
            **before, "time_loop": before["time_loop"] + 1}, K
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6,
                                   err_msg=f"dropout K={K}")
        # a generator draws masks of the same kind: another output, and
        # the same one again from the same seed
        drawn = [tdrnmf.drnmf_forward(
            tparams, tcfg, xt, training=True,
            generator=torch.Generator().manual_seed(3)) for _ in range(2)]
        assert torch.equal(drawn[0], drawn[1]), K
        assert not torch.allclose(drawn[0], got), K
        # eval mode ignores dropout (and its masks); training needs draws
        plain_cfg = dataclasses.replace(tcfg, dropout_U=0.0, dropout_W=0.0)
        np.testing.assert_array_equal(
            tdrnmf.drnmf_forward(tparams, tcfg, xt, dropout=masks).numpy(),
            tdrnmf.drnmf_forward(tparams, plain_cfg, xt).numpy())
        with pytest.raises(ValueError, match="generator"):
            tdrnmf.drnmf_forward(tparams, tcfg, xt, training=True)
        masks_u = tdrnmf.dropout_masks(tcfg, 50, F, torch.Generator()
                                       .manual_seed(0), "cpu")
        for m, rate in zip(masks_u, rates):
            if rate == 0:
                assert m is None
            else:  # kept entries scaled by 1/(1 - rate), the rest zero
                vals = set(np.unique(m.numpy()).tolist())
                assert vals <= {0.0, np.float32(1 / (1 - rate))}, vals

    # the fold route gives log_U1/log_Uk no gradient; the module trains
    # what the mask says
    jcfg, tcfg = _configs(K=2)
    tparams = params_from_numpy(_params(rng, jcfg), "cpu")
    for name in ("log_U1", "log_Uk", "log_D_1"):
        tparams[name].requires_grad_(True)
    out = tdrnmf.drnmf_forward(tparams, tcfg, torch.from_numpy(x))
    u1, uk, d1 = torch.autograd.grad(
        out.sum(), [tparams[k] for k in ("log_U1", "log_Uk", "log_D_1")],
        allow_unused=True)
    assert u1 is None and uk is None and d1.abs().sum() > 0
    model = tdrnmf.DRNMF(tcfg, params_from_numpy(_params(rng, jcfg), "cpu"))
    assert sorted(k for k, p in model.params.items() if p.requires_grad) == [
        "log_D_0", "log_D_1", "log_W_clean", "log_W_noise", "log_alph_0",
        "log_alph_1", "log_h0"]


def _jax_grads(params, jcfg, x, y, mask):
    def loss(p, xx):
        irm = jdrnmf.drnmf_forward(p, jcfg, xx)
        return jlosses.masked_mse_signal_approx(irm, xx, jnp.asarray(y),
                                                jnp.asarray(mask))

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    return jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))


def _port_grads(params, tcfg, trains, x, y, mask, scan_fn=None, **kw):
    tparams = _trainable(params_from_numpy(params, "cpu"), trains)
    xt = torch.from_numpy(x).requires_grad_(True)
    irm = tdrnmf.drnmf_forward(tparams, tcfg, xt, scan_fn=scan_fn, **kw)
    loss = tlosses.masked_mse_signal_approx(irm, xt, torch.from_numpy(y),
                                            torch.from_numpy(mask))
    names = sorted(k for k in tparams if trains[k])
    got = torch.autograd.grad(loss, [tparams[k] for k in names] + [xt])
    return dict(zip(names + ["x"], got))


def test_gradients_match_jax(rng, monkeypatch):
    """The masked-MSE loss's gradients through the port's training route
    (the Function on its plain versions) against ``jax.grad`` of the same
    loss with the JAX package's batched backward and with autodiff, for
    every trainable parameter and the input; the Function's plain backward
    against autograd through the port's time loop (the dropout route with
    keep masks of ones)."""
    for K in (1, 2, 3):
        for r in (4, 6):
            jcfg, tcfg = _configs(K=K, r=r)
            params = _params(rng, jcfg, r=r)
            trains = tdrnmf.drnmf_trainable_mask(tcfg, params)
            x, y, mask = _data(rng)
            before = dict(drnmf_scan.LAUNCHES)
            got = _port_grads(params, tcfg, trains, x, y, mask)
            assert drnmf_scan.LAUNCHES == before, (K, r)  # plain versions
            for batched in (True, False):
                ref_p, ref_x = _jax_grads(
                    params, dataclasses.replace(jcfg, batched_grad=batched),
                    x, y, mask)
                for name, g in got.items():
                    want = ref_x if name == "x" else ref_p[name]
                    np.testing.assert_allclose(
                        g.numpy(), np.asarray(want),
                        err_msg=f"K={K} r={r} batched={batched} {name}",
                        **GRAD_TOL)
            ones = (torch.ones((B, 2 * r)), torch.ones((B, F)))
            loop_cfg = dataclasses.replace(tcfg, dropout_U=0.5,
                                           dropout_W=0.5)
            looped = _port_grads(params, loop_cfg, trains, x, y, mask,
                                 training=True, dropout=ones)
            assert drnmf_scan.LAUNCHES["time_loop"] == before["time_loop"] + 1
            for name, g in got.items():
                np.testing.assert_allclose(
                    g.numpy(), looped[name].numpy(), rtol=1e-5, atol=1e-7,
                    err_msg=f"K={K} r={r} time loop {name}")

    # the residual gate raises with the sizes; the plain forward is not
    # reached
    jcfg, tcfg = _configs(K=3)
    params = _params(rng, jcfg)
    trains = tdrnmf.drnmf_trainable_mask(tcfg, params)
    need = batched_grad.batched_grad_residual_bytes(B, T, 2 * R, 3)
    assert need == 2 * 4 * B * T * 2 * R * 3
    assert batched_grad.batched_grad_residual_bytes(32, 500, 2000, 5) == \
        1_280_000_000
    monkeypatch.setattr(batched_grad, "residual_budget",
                        lambda device: need - 1)
    with pytest.raises(RuntimeError, match=f"keeps {need} bytes.*B={B}, "
                       f"T={T}, 2r={2 * R}, K=3.*cut the batch size"):
        _port_grads(params, tcfg, trains, *_data(rng))
    monkeypatch.setattr(batched_grad, "residual_budget", lambda device: need)
    _port_grads(params, tcfg, trains, *_data(rng))


def _striped_backward(g, step_mask, h_all, diag1, off1, c_uk, dkt_stack,
                      dka_stack, stripe, sub, chunk):
    """The backward kernel's order of arithmetic in plain PyTorch: 2r cut
    into stripes of ``stripe`` columns; each back-projection a partial per
    stripe, the partials summed in chunks of ``chunk`` stripes (each
    ascending), the chunks in order; each projection over F in
    sub-stretches of ``sub`` depths added in order; each stripe's rowsum
    over its columns ascending, its row total c*(rowsums of d_{K-1}..d_1,
    in that order) + off1*rowsum(d_0), and the next step's per-row total
    summed over stripes as p is.  Arguments and results as for
    ``drnmf_scan_factored_backward_reference``."""
    bsz, t_len, n2r = g.shape
    k_layers, bp = h_all.shape[0], h_all.shape[3]
    f = dka_stack.shape[1]
    cols = [slice(c, min(n2r, c + stripe)) for c in range(0, n2r, stripe)]
    subs = [slice(u, min(f, u + sub)) for u in range(0, f, sub)]
    chunks = [range(c, min(len(cols), c + chunk))
              for c in range(0, len(cols), chunk)]

    def over_stripes(parts):
        total = None
        for ch in chunks:
            v = parts[ch[0]]
            for s in ch[1:]:
                v = v + parts[s]
            total = v if total is None else total + v
        return total

    def rowsums(d):
        out = []
        for c in cols:
            v = d[:, c.start]
            for j in range(c.start + 1, c.stop):
                v = v + d[:, j]
            out.append(v)
        return out

    delta = g.new_zeros((k_layers, n2r, t_len, bp))
    p_all = g.new_zeros((k_layers - 1, f, t_len, bp))
    zero = g.new_zeros(())
    gb = d_next = rowtot = None
    for t in reversed(range(t_len)):
        h_t = h_all[:, :, t, :bsz].transpose(1, 2)  # (K, B, 2r)
        go = g[:, t]
        if rowtot is not None:
            go = go + (gb + d_next * (diag1 - off1)
                       + over_stripes(rowtot)[:, None])
        valid = step_mask[:, t, None]
        gb = torch.where(valid, zero, go)
        d = torch.where(valid & (h_t[-1] > 0), go, zero)
        delta[-1, :, t, :bsz] = d.T
        upper = rowsums(d)
        for k in range(k_layers - 1, 0, -1):
            p = over_stripes([d[:, c] @ dka_stack[k][:, c].T for c in cols])
            p_all[k - 1, :, t, :bsz] = p.T
            red = [p[:, u] @ dkt_stack[k - 1][:, u].T for u in subs]
            total = red[0]
            for r in red[1:]:
                total = total + r
            d = torch.where(h_t[k - 1] > 0, d - total, zero)
            delta[k - 1, :, t, :bsz] = d.T
            if k > 1:
                upper = [a + b for a, b in zip(upper, rowsums(d))]
        if k_layers > 1:
            rowtot = [c_uk * a + off1 * b for a, b in zip(upper, rowsums(d))]
        else:
            rowtot = [off1 * b for b in upper]
        d_next = d
    gamma = gb + d_next * (diag1 - off1) + over_stripes(rowtot)[:, None]
    return delta, p_all, gamma


def test_backward_kernel_order_matches_jax(rng):
    """The backward kernel's order of arithmetic (``_striped_backward``) at
    stripes of 4 columns, sub-stretches of 2 and chunks of 2 stripes, and
    at the kernel's own plan (``drnmf_scan.backward_plan``), on the same
    numpy inputs as ``jax.vjp`` of the JAX package's
    ``scan_plain_batched``: gamma and, through ``_weight_grads``, every
    weight gradient and the input's, at ``GRAD_TOL``; its deltas and p
    against ``drnmf_scan_factored_backward_reference`` at rtol 1e-5 /
    atol 1e-6 (f32 both sides, sums in another order).  K = 1, 2, 3,
    ragged batches, F and 2r that no stripe or sub-stretch divides, a
    masked tail and a masked step mid-sequence."""
    import types

    from drnmf_tpu.models.batched_grad import scan_plain_batched

    for bsz, t_len, f, r, K in ((5, 9, 9, 7, 1), (3, 8, 33, 7, 2),
                                (5, 7, 17, 12, 3), (2, 6, 9, 20, 3)):
        jcfg, tcfg = _configs(K=K, r=r, input_dim=f, output_dim=f)
        w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
        w /= np.sqrt(np.sum(w**2, axis=0))
        tparams = params_from_numpy(
            {k: np.asarray(v) for k, v in jax_init(jcfg, w).items()}, "cpu")
        x = rng.uniform(0, 1, (bsz, t_len, f)).astype(np.float32)
        x[bsz // 2, t_len - 3:] = tcfg.mask_value
        x[-1, 2] = tcfg.mask_value
        xt = torch.from_numpy(x)
        args = tdrnmf.factored_scan_operands(
            tparams, tcfg, xt, tdrnmf.step_mask_from_input(
                xt, tcfg.mask_value))
        # off1 and c at 1e-7 (the fold of the initial U) would hide the
        # rowsum terms: any values of them give a valid recurrence
        args = tuple(a.detach() for a in args[:4]) + (
            torch.tensor(0.02), torch.tensor(-0.03)) + tuple(
            a.detach() for a in args[6:])
        _, h_all = drnmf_scan.drnmf_scan_factored_reference(
            *args, keep_layers=True)
        g = torch.from_numpy(rng.standard_normal(
            (bsz, t_len, 2 * r)).astype(np.float32))
        back = (g, args[1], h_all, *args[3:8])
        ref = drnmf_scan.drnmf_scan_factored_backward_reference(*back)

        xs, mask, h0, diag1, off1, c_uk, dkt, dka, b = (
            jnp.asarray(a.numpy()) for a in args)
        dks = [dkt[k - 1].T for k in range(1, K)]
        static = (K, 1, jax.lax.Precision.HIGHEST)
        _, vjp = jax.vjp(
            lambda dks, dkas, w0, bs, h, xT: scan_plain_batched(
                static, (diag1, off1, c_uk), dks, dkas, w0, bs, h, xT,
                mask.T.astype(jnp.float32)),
            dks, [dka[k] for k in range(1, K)], dka[0],
            [b[k] for k in range(K)], h0, xs.swapaxes(0, 1))
        j_dks, j_dkas, j_w0, j_bs, j_h, j_x = vjp(
            jnp.asarray(g.numpy()).swapaxes(0, 1))
        want = {"gamma": j_h, "d_x": np.asarray(j_x).swapaxes(0, 1),
                "d_dka_0": j_w0}
        for k in range(K):
            want[f"d_b_{k}"] = j_bs[k]
        for k in range(1, K):
            want[f"d_dka_{k}"] = j_dkas[k - 1]
            want[f"d_dkt_{k - 1}"] = np.asarray(j_dks[k - 1]).T

        plan = drnmf_scan.backward_plan(bsz, f, 2 * r, K, 1 << 30,
                                        lambda *a: 1, lambda *a: 0)
        for stripe, sub, chunk in ((4, 2, 2),
                                   (plan.stripe, plan.sub, plan.chunk)):
            case = f"B{bsz}_T{t_len}_F{f}_r{r}_K{K} W={stripe}"
            delta, p_all, gamma = _striped_backward(*back, stripe, sub,
                                                    chunk)
            for name, a, b in zip(("delta", "p"), (delta, p_all), ref):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=f"{case} {name}")
            d_x, d_dkt, d_dka, d_b = batched_grad._weight_grads(
                types.SimpleNamespace(needs_input_grad=(False, True)),
                args[0], h_all, delta, p_all, args[6], args[7])
            got = {"gamma": gamma, "d_x": d_x, "d_dka_0": d_dka[0]}
            for k in range(K):
                got[f"d_b_{k}"] = d_b[k]
            for k in range(1, K):
                got[f"d_dka_{k}"] = d_dka[k]
                got[f"d_dkt_{k - 1}"] = d_dkt[k - 1]
            assert got.keys() == want.keys(), case
            for name, a in got.items():
                np.testing.assert_allclose(a.numpy(), np.asarray(want[name]),
                                           err_msg=f"{case} {name}",
                                           **GRAD_TOL)


def _loss_fns(jcfg, tcfg):
    def jloss(p, x, y, mask):
        return jlosses.masked_mse_signal_approx(
            jdrnmf.drnmf_apply(p, jcfg, x), x, y, mask)

    def tloss(p, x, y, mask):
        return tlosses.masked_mse_signal_approx(
            tdrnmf.drnmf_forward(p, tcfg, x), x, y, mask)

    return jloss, tloss


def _compare_params(got, want, trains, msg, atol=1e-6):
    """Trainable parameters at rtol 1e-4 / ``atol``, frozen ones bit for
    bit."""
    for name, w in want.items():
        g = np.asarray(got[name].detach() if hasattr(got[name], "detach")
                       else got[name])
        w = np.asarray(w)
        if trains[name]:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol,
                                       err_msg=f"{msg} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{msg} {name}")


def test_keras_adam_matches_optax(rng):
    """Three Adam steps with decay and clipnorm on identical batches, from
    the same JAX-initialised parameters, in both packages: losses at rtol
    1e-4, parameters as ``_compare_params`` holds them, frozen parameters
    bit for bit; the clip engages (the first gradient's norm is past
    clipnorm) and the learning rate decays."""
    for K, clipnorm in ((1, 0.005), (3, 0.005), (2, 100.0)):
        jcfg, tcfg = _configs(K=K)
        params = _params(rng, jcfg)
        trains = tdrnmf.drnmf_trainable_mask(tcfg, params)
        tc = tloop.TrainConfig(learning_rate=1e-2, decay=0.3,
                               clipnorm=clipnorm, verbose=False)
        jtc = jloop.TrainConfig(**dataclasses.asdict(tc))
        jloss, tloss = _loss_fns(jcfg, tcfg)
        x, y, mask = _data(rng)

        opt = jloop.make_optimizer(jtc, trains)
        jparams = {k: jnp.array(v) for k, v in params.items()}
        state = opt.init(jparams)
        jstep = jloop.make_train_step(jloss, opt)
        tparams = _trainable(params_from_numpy(params, "cpu"), trains)
        topt = tloop.make_optimizer(tc, tparams, trains)
        tstep = tloop.make_train_step(tloss, topt)
        norm0 = None
        for i in range(3):
            jparams, state, jl = jstep(jparams, state, jnp.asarray(x),
                                       jnp.asarray(y), jnp.asarray(mask))
            tl = tstep(tparams, *(torch.from_numpy(a) for a in (x, y, mask)))
            if norm0 is None:
                norm0 = float(torch.sqrt(sum(
                    torch.sum(p.grad * p.grad) for p in topt.params)))
            # Adam divides each gradient by its own root mean square, so an
            # entry whose gradient is zero within rounding would move by up
            # to lr a step in a direction rounding picks; these cases have
            # none (each |g| > 1e-6 of its parameter's largest), so every
            # entry is held at the strict tolerance
            for name, p in zip(topt.names, topt.params):
                g = p.grad.abs()
                assert (g > 1e-6 * g.max()).all(), (K, i, name)
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4,
                                       err_msg=f"K={K} step {i}")
        assert topt.count == 3
        assert (norm0 > clipnorm) == (clipnorm < 1), (K, norm0, clipnorm)
        _compare_params(tparams, jparams, trains, f"K={K} clip={clipnorm}")


def test_train_model_matches_jax(rng, tmp_path, monkeypatch):
    """A short fit in both packages from the same parameters and data: the
    per-batch and per-epoch history within rtol 1e-4, early stopping at
    the same epoch, the best parameters alike; the port's best-only
    ``.npz`` loads in the JAX package with ``val_loss`` in its meta;
    ``epochs=0`` writes the initial values; the history pickle has the JAX
    layout; batches copied in from the host train as gathered ones do;
    dropout draws repeat from the seed; the entry point refuses the CPU
    unless asked."""
    jcfg, tcfg = _configs(K=2)
    params = _params(rng, jcfg)
    trains = tdrnmf.drnmf_trainable_mask(tcfg, params)
    train = _data(rng, n=7)
    valid = _data(rng, n=4)
    jloss, tloss = _loss_fns(jcfg, tcfg)
    tc = tloop.TrainConfig(epochs=12, batch_size=3, learning_rate=0.2,
                           clipnorm=1.0, decay=0.01, patience=1,
                           verbose=False)
    jtc = jloop.TrainConfig(**dataclasses.asdict(tc))
    jbest, jhist = jloop.train_model(
        params, jloss, train, valid, jtc, trainable_mask=trains,
        savefile=str(tmp_path / "jax.npz"),
        histfile=str(tmp_path / "jax.pkl"))
    tbest, thist = tloop.train_model(
        params, tloss, train, valid, tc, trainable_mask=trains,
        savefile=str(tmp_path / "port.npz"),
        histfile=str(tmp_path / "port.pkl"), device="cpu")
    # batches gathered on the host and copied in (the splits kept off the
    # device) train the same
    monkeypatch.setattr(tloop, "DEVICE_DATA_SHARE", 0.0)
    hbest, hhist = tloop.train_model(params, tloss, train, valid, tc,
                                     trainable_mask=trains, device="cpu")
    assert hhist.history == thist.history
    for k in tbest:
        np.testing.assert_array_equal(hbest[k], tbest[k], err_msg=k)
    want, got = jhist.history, thist.history
    n_epochs = len(want["on_epoch_end"]["val_loss"])
    assert 2 < n_epochs < tc.epochs  # it stopped early
    assert len(got["on_epoch_end"]["val_loss"]) == n_epochs
    for where in ("on_batch_end", "on_epoch_end"):
        assert got[where].keys() == want[where].keys(), where
        for key in want[where]:
            np.testing.assert_allclose(got[where][key], want[where][key],
                                       rtol=1e-4, err_msg=f"{where} {key}")
    # each of the fit's Adam steps moves an entry by up to lr, and the two
    # packages' steps differ in rounding: held within 1e-4 of lr a step
    _compare_params(tbest, jbest, trains, "fit",
                    atol=1e-4 * tc.learning_rate
                    * len(want["on_batch_end"]["loss"]))

    loaded, meta = jcheckpoint.load_checkpoint(str(tmp_path / "port.npz"))
    assert loaded.keys() == tbest.keys()
    for k in loaded:
        np.testing.assert_array_equal(loaded[k], tbest[k], err_msg=k)
    assert float(meta["val_loss"]) == min(got["on_epoch_end"]["val_loss"])
    with open(tmp_path / "port.pkl", "rb") as fh:
        pickled = pickle.load(fh)
    assert pickled == thistory.LossHistory.load(str(tmp_path / "port.pkl"))
    assert set(pickled) == {"on_batch_end", "on_epoch_end"}
    assert pickled["on_epoch_end"].keys() == {"loss", "val_loss"}
    assert all(isinstance(v, float) for v in pickled["on_batch_end"]["loss"])
    resumed = thistory.LossHistory(str(tmp_path / "port.pkl"), resume=True)
    assert resumed.history == pickled

    best0, _ = tloop.train_model(
        params, tloss, train, valid, dataclasses.replace(tc, epochs=0),
        trainable_mask=trains, savefile=str(tmp_path / "init.npz"),
        device="cpu")
    loaded, meta = jcheckpoint.load_checkpoint(str(tmp_path / "init.npz"))
    assert np.isinf(meta["val_loss"])
    for k in params:
        np.testing.assert_array_equal(loaded[k], params[k], err_msg=k)
        np.testing.assert_array_equal(best0[k], params[k], err_msg=k)

    # with loss_takes_rng the loss draws dropout from a generator seeded by
    # the seed and the global step: a fit repeats, another seed differs
    dcfg = dataclasses.replace(tcfg, dropout_U=0.3, dropout_W=0.2)

    def dropout_loss(p, x, y, mask, generator):
        irm = tdrnmf.drnmf_forward(p, dcfg, x, training=True,
                                   generator=generator)
        return tlosses.masked_mse_signal_approx(irm, x, y, mask)

    fits = [tloop.train_model(params, dropout_loss, train, valid,
                              dataclasses.replace(tc, epochs=2, seed=seed),
                              trainable_mask=trains, eval_loss_fn=tloss,
                              loss_takes_rng=True, device="cpu")[1].history
            for seed in (5, 5, 6)]
    assert fits[0] == fits[1]
    assert fits[0]["on_batch_end"] != fits[2]["on_batch_end"]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.train_model(params, tloss, train, valid, tc)


def test_train_resume_continues_exactly(rng, tmp_path, monkeypatch):
    """Elastic resume, the counterparts of the JAX package's
    ``test_train_resume_exact_continuation``,
    ``test_periodic_state_save_same_result``,
    ``test_resume_frozen_fingerprint_mismatch_raises`` and
    ``test_training_deadline_aborts_cleanly_and_resumes``: a fit cut after
    3 of 6 epochs (or stopped by ``DRNMF_TRAIN_DEADLINE_TS`` after its
    first) and resumed equals the uninterrupted fit exactly on the CPU,
    history included, every epoch's state written or every 4th
    (``DRNMF_STATE_EVERY``), with a frozen parameter and with a loss that
    draws from the step-seeded generator; a changed frozen value refuses
    to resume; ``train_state_incomplete`` reads the state."""
    n, t, f = 12, 6, 5
    x = rng.uniform(0, 1, (n, t, f)).astype(np.float32)
    y = rng.uniform(0, 1, (n, t, f)).astype(np.float32)
    mask = np.ones((n, t), np.float32)
    params0 = {"w": np.zeros((f, f), np.float32),
               "b": np.zeros((f,), np.float32),
               "frozen": np.ones((f,), np.float32)}
    trains = {"w": True, "b": True, "frozen": False}

    def loss_fn(p, xb, yb, mb):
        return torch.mean((xb @ p["w"] + p["b"] + p["frozen"] - yb) ** 2)

    def noisy_loss(p, xb, yb, mb, generator):
        keep = torch.rand(xb.shape, generator=generator) < 0.8
        return loss_fn(p, xb * keep, yb, mb)

    def run(name, epochs, rng_loss=False, init=params0):
        return tloop.train_model(
            dict(init), noisy_loss if rng_loss else loss_fn, (x, y, mask),
            (x, y, mask),
            tloop.TrainConfig(epochs=epochs, batch_size=4, learning_rate=1e-2,
                              verbose=False),
            trainable_mask=trains, savefile=str(tmp_path / f"{name}.npz"),
            histfile=str(tmp_path / f"{name}.hist"), eval_loss_fn=loss_fn,
            loss_takes_rng=rng_loss, resume=True, device="cpu")

    def same(got, want, msg):
        (gp, gh), (wp, wh) = got, want
        assert gh.history == wh.history, msg
        for k in wp:
            np.testing.assert_array_equal(gp[k], wp[k], err_msg=f"{msg} {k}")

    monkeypatch.delenv("DRNMF_TRAIN_DEADLINE_TS", raising=False)
    for every in ("1", "4"):
        monkeypatch.setenv("DRNMF_STATE_EVERY", every)
        for rng_loss in (False, True):
            case = f"every{every}_rng{int(rng_loss)}"
            full = run(f"full_{case}", 6, rng_loss)
            run(f"part_{case}", 3, rng_loss)
            savefile = str(tmp_path / f"part_{case}.npz")
            assert os.path.exists(savefile + ".train_state"), case
            assert tloop.train_state_incomplete(savefile, 6, 50)
            assert not tloop.train_state_incomplete(savefile, 3, 50)
            same(run(f"part_{case}", 6, rng_loss), full, case)
            # the best checkpoint on disk is the returned one
            ck, meta = jcheckpoint.load_checkpoint(
                str(tmp_path / f"part_{case}.npz"))
            for k in full[0]:
                np.testing.assert_array_equal(ck[k], full[0][k])
            assert float(meta["val_loss"]) == min(
                full[1].history["on_epoch_end"]["val_loss"])
    monkeypatch.delenv("DRNMF_STATE_EVERY")

    full = run("deadline_full", 5)
    monkeypatch.setenv("DRNMF_TRAIN_DEADLINE_TS", "1.0")  # long past
    with pytest.raises(tloop.TrainingDeadline, match="epoch 1/5"):
        run("deadline", 5)
    assert (tmp_path / "deadline.npz.train_state").exists()
    monkeypatch.delenv("DRNMF_TRAIN_DEADLINE_TS")
    same(run("deadline", 5), full, "deadline")
    # a deadline at the last epoch does not raise; a finished fit replays
    monkeypatch.setenv("DRNMF_TRAIN_DEADLINE_TS", "1.0")
    replay = run("deadline", 5)
    for k in full[0]:
        np.testing.assert_array_equal(replay[0][k], full[0][k])
    monkeypatch.delenv("DRNMF_TRAIN_DEADLINE_TS")

    changed = dict(params0, frozen=2.0 * params0["frozen"])
    with pytest.raises(ValueError, match="fingerprint"):
        run("deadline", 8, init=changed)
    with open(tmp_path / "deadline.npz.train_state", "rb") as fh:
        state = pickle.load(fh)
    assert "frozen" not in state["params"] and \
        "frozen" not in state["best_params"]
    assert state["opt"]["names"] == ["b", "w"] and state["opt"]["count"] == 15
