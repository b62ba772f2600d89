"""The LSTM baseline of the port (drnmf_torch.models.lstm) against the JAX
package's, on the CPU.

The JAX package's initial parameters are handed across as numpy (the two
random number generators differ).  Tolerances: the forward rtol 1e-5 /
atol 1e-6 (the model tests' tolerance; the port folds the hard sigmoid's
slope into the gate columns, so its sums round otherwise); gradients of the
masked loss within 1e-4 of each gradient's largest entry (the training
tests' gradient tolerance: long chains of f32 products summed in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from drnmf_tpu.models import lstm as jlstm
from drnmf_tpu.train import losses as jlosses
from drnmf_torch.convert import params_from_numpy
from drnmf_torch.models import lstm as tlstm
from drnmf_torch.train import losses as tlosses

F = 9


def _configs(K=2, hidden=8):
    kw = dict(input_dim=F, hidden_dim=hidden, output_dim=F, K_layers=K,
              mask_value=-1.0)
    return jlstm.LSTMConfig(**kw), tlstm.LSTMConfig(**kw)


def _data(rng, b=4, t=13):
    """Magnitudes with masked tails (row 1 from step 8, row 3 from step 2)
    and a masked step inside row 2."""
    x = rng.uniform(0.0, 2.0, (b, t, F)).astype(np.float32)
    y = (x * rng.uniform(0.0, 1.0, x.shape)).astype(np.float32)
    mask = np.ones((b, t, 1), np.float32)
    for row, start in ((1, 8), (3, 2)):
        x[row, start:] = -1.0
        mask[row, start:] = 0.0
    x[2, 5] = -1.0
    mask[2, 5] = 0.0
    return x, y, mask


def test_lstm_forward_and_gradients_match_jax(rng):
    """K = 1, 2, 3 (hidden 8, and 5 at K = 2) with masked tails: the mask,
    each layer's states held on masked steps, and the gradients of the
    masked signal-approximation loss against ``jax.grad``; the
    ``nn.Module`` wrapper equals the function."""
    for K, hidden in ((1, 8), (2, 8), (2, 5), (3, 8)):
        jcfg, tcfg = _configs(K, hidden)
        params = {k: np.asarray(v) for k, v in jlstm.init_lstm_params(
            jcfg, jax.random.PRNGKey(K)).items()}
        x, y, mask = _data(rng)
        want = np.asarray(jlstm.lstm_apply(params, jcfg, jnp.asarray(x)))
        tparams = params_from_numpy(params, "cpu")
        xt = torch.from_numpy(x)
        got = tlstm.lstm_forward(tparams, tcfg, xt)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"K={K} hidden={hidden}")
        module = tlstm.LSTM(tcfg, tparams)
        with torch.no_grad():
            np.testing.assert_array_equal(module(xt).numpy(), got.numpy())
        # a masked step holds the state: the mask repeats the step before
        np.testing.assert_array_equal(got[1, 8:].numpy(),
                                      np.broadcast_to(got[1, 7].numpy(),
                                                      (5, F)))

        def jloss(p):
            irm = jlstm.lstm_apply(p, jcfg, jnp.asarray(x))
            return jlosses.masked_mse_signal_approx(
                irm, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))

        jgrads = jax.grad(jloss)({k: jnp.asarray(v)
                                  for k, v in params.items()})
        for v in tparams.values():
            v.requires_grad_(True)
        loss = tlosses.masked_mse_signal_approx(
            tlstm.lstm_forward(tparams, tcfg, xt), xt, torch.from_numpy(y),
            torch.from_numpy(mask))
        np.testing.assert_allclose(float(loss.detach()),
                                   float(jloss(params)), rtol=1e-5)
        loss.backward()
        for name, g in jgrads.items():
            g = np.asarray(g)
            err = np.abs(tparams[name].grad.numpy() - g).max()
            assert err <= 1e-4 * np.abs(g).max(), (K, hidden, name, err)


def test_lstm_init():
    """The port's initial values: the JAX layout and shapes, a unit forget
    bias and zero biases elsewhere, orthogonal recurrent blocks per gate,
    Glorot-uniform input kernels within their limit; a seeded generator
    repeats, another seed differs."""
    jcfg, tcfg = _configs(K=3, hidden=6)
    want = jlstm.init_lstm_params(jcfg)
    got = tlstm.init_lstm_params(tcfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    n = tcfg.hidden_dim
    for k in range(tcfg.K_layers):
        b = got[f"lstm{k}_b"].numpy()
        np.testing.assert_array_equal(b[n:2 * n], 1.0)
        np.testing.assert_array_equal(np.delete(b, np.s_[n:2 * n]), 0.0)
        wh = got[f"lstm{k}_Wh"].numpy()
        for g in range(4):
            block = wh[:, g * n:(g + 1) * n]
            np.testing.assert_allclose(block.T @ block, np.eye(n),
                                       atol=1e-5, err_msg=f"{k} gate {g}")
        wx = got[f"lstm{k}_Wx"].numpy()
        limit = np.sqrt(6.0 / sum(wx.shape))
        assert np.abs(wx).max() <= limit and wx.std() > 0.3 * limit
    np.testing.assert_array_equal(got["dense_b"].numpy(), 0.0)
    again = tlstm.init_lstm_params(tcfg, device="cpu")
    other = tlstm.init_lstm_params(
        tcfg, generator=torch.Generator().manual_seed(1), device="cpu")
    for k in got:
        assert torch.equal(got[k], again[k]), k
    assert not torch.equal(got["lstm0_Wx"], other["lstm0_Wx"])
