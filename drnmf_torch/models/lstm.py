"""LSTM mask-prediction baseline (counterpart of
``drnmf_tpu/models/lstm.py``; the reference's Keras baseline,
enhance.py:321-345): Masking -> K stacked LSTM(hidden_dim,
return_sequences) -> TimeDistributed Dense -> sigmoid, the predicted ratio
mask.

The cell has Keras 2.0.4's defaults, which the reference relied on: a
``tanh`` cell, the ``hard_sigmoid`` recurrent gate max(0, min(1, 0.2x +
0.5)), a unit forget-gate bias, Glorot-uniform input kernels and orthogonal
recurrent kernels, gates packed i, f, c, o on the last axis.  cuDNN's LSTM
(``nn.LSTM``) has a plain sigmoid gate, so it is not this model: the time
loop is PyTorch's, one ``addmm`` and six elementwise ops a step (the hard
sigmoid's slope and offset folded into the gate columns once a call), with
the input projection of all steps hoisted out of the loop as one
``torch.matmul``; autograd gives the gradients.  Masked steps hold (h, c)
(two more ops, on the steps where a row is masked).

Parameters are the flat dict the JAX package uses (``lstm{k}_Wx`` (D, 4N),
``lstm{k}_Wh`` (N, 4N), ``lstm{k}_b`` (4N,), ``dense_W`` (N, F),
``dense_b`` (F,)), so they cross between the packages as the ``.npz``
checkpoints hold them (``convert.params_from_numpy``).
"""

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..device import params_on_device, resolve_device


@dataclass(frozen=True)
class LSTMConfig:
    input_dim: int = 257
    hidden_dim: int = 250
    output_dim: int = 257
    K_layers: int = 2
    mask_value: float = -1.0


def _glorot(generator, shape):
    limit = np.sqrt(6.0 / (shape[0] + shape[1]))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * 2.0 - 1.0) * float(limit)


def _orthogonal(generator, n):
    a = torch.randn((n, n), generator=generator, dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    return q * torch.sign(torch.diagonal(r))[None, :]


def init_lstm_params(config: LSTMConfig, generator=None,
                     device="cuda") -> dict:
    """Initial parameters as the JAX package lays them out; the values are
    drawn on the CPU from ``generator`` (a ``torch.Generator``; seed 7654
    when None), so they differ from the JAX package's, with the same law.
    Returns name -> float32 tensor on ``device``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(7654)
    params = {}
    dim_in, n = config.input_dim, config.hidden_dim
    for layer in range(config.K_layers):
        params[f"lstm{layer}_Wx"] = _glorot(generator, (dim_in, 4 * n))
        params[f"lstm{layer}_Wh"] = torch.cat(
            [_orthogonal(generator, n) for _ in range(4)], dim=1)
        bias = torch.zeros(4 * n)
        bias[n: 2 * n] = 1.0  # unit forget-gate bias
        params[f"lstm{layer}_b"] = bias
        dim_in = n
    params["dense_W"] = _glorot(generator, (n, config.output_dim))
    params["dense_b"] = torch.zeros(config.output_dim)
    return params_on_device(params, device)


def _lstm_layer(wx, wh, b, x, step_mask, full_steps):
    """x: (B, T, D) -> (B, T, N).  Masked steps hold (h, c);
    ``full_steps[t]`` is True where no row is masked at step t."""
    n = wh.shape[0]
    # the hard sigmoid's 0.2x + 0.5 folded into the i, f, o columns, so a
    # step's gates are one addmm and one clamp
    scale = torch.full((4 * n,), 0.2, dtype=wh.dtype, device=wh.device)
    shift = torch.full_like(scale, 0.5)
    scale[2 * n: 3 * n] = 1.0  # the cell's column block: tanh, unscaled
    shift[2 * n: 3 * n] = 0.0
    # every step's input projection at once: (T, B, 4N)
    zx = (torch.matmul(x.transpose(0, 1), wx) + b) * scale + shift
    wh = wh * scale
    h = x.new_zeros((x.shape[0], n))
    c = x.new_zeros((x.shape[0], n))
    mask_t = step_mask.transpose(0, 1)[..., None]  # (T, B, 1)
    outs = []
    # unbind and split: one backward op each, where indexing a step or a
    # gate would give each its own zero-filled gradient of the whole
    for t, zx_t in enumerate(zx.unbind(0)):
        z = torch.addmm(zx_t, h, wh)
        i, f, _, o = torch.clamp(z, 0.0, 1.0).split(n, dim=1)
        c_new = torch.addcmul(f * c, i, torch.tanh(z.split(n, dim=1)[2]))
        h_new = o * torch.tanh(c_new)
        if full_steps[t]:
            h, c = h_new, c_new
        else:
            h = torch.where(mask_t[t], h_new, h)
            c = torch.where(mask_t[t], c_new, c)
        outs.append(h)
    if not outs:
        return x.new_empty((x.shape[0], 0, n))
    return torch.stack(outs, dim=1)


def lstm_forward(params: dict, config: LSTMConfig, x) -> torch.Tensor:
    """(B, T, F) noisy magnitudes -> (B, T, F) sigmoid mask (``lstm_apply``
    of the JAX package).  A step is masked where every feature equals
    ``config.mask_value``."""
    step_mask = torch.any(x != config.mask_value, dim=-1)
    full_steps = step_mask.all(dim=0).tolist()  # one host read a call
    h = x
    for layer in range(config.K_layers):
        h = _lstm_layer(params[f"lstm{layer}_Wx"], params[f"lstm{layer}_Wh"],
                        params[f"lstm{layer}_b"], h, step_mask, full_steps)
    return torch.sigmoid(torch.matmul(h, params["dense_W"])
                         + params["dense_b"])


class LSTM(nn.Module):
    """The model as a module: the flat parameter dict as
    ``nn.Parameter``s, run by :func:`lstm_forward`."""

    def __init__(self, config: LSTMConfig, params: dict):
        super().__init__()
        self.config = config
        self.params = nn.ParameterDict({
            k: nn.Parameter(torch.as_tensor(v)) for k, v in params.items()})

    def forward(self, x):
        return lstm_forward(dict(self.params), self.config, x)
