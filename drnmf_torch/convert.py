"""Parameters across from the JAX package, and the model's initial values.

Parameters move between the two packages as the flat name -> array dict
that the ``.npz`` checkpoints hold.  Tests hand the JAX package's
initialised parameters to the port this way, because the two packages'
random number generators differ.
"""

import numpy as np
import torch

from .device import resolve_device
from .models.drnmf import _EPS7, DRNMFConfig


def params_from_numpy(params: dict, device="cuda") -> dict:
    """name -> array (numpy, or anything ``np.asarray`` takes, such as a
    JAX array) -> name -> float32 tensor on ``device``.  Each array is
    copied: ``np.asarray`` of a JAX array is read-only."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
            .to(device) for k, v in params.items()}


def init_drnmf_params(config: DRNMFConfig, w_noisy, generator=None,
                      device="cuda") -> dict:
    """Build the alternate-parameter dict from an SNMF dictionary.

    ``w_noisy``: (input_dim, 2r) nonnegative dictionary [W_clean, W_noise]
    with unit-L2 columns.  Every entry equals the JAX package's
    ``init_drnmf_params`` except ``log_h0``, which is drawn from
    uniform(-0.05, 0.05) with ``generator`` (a ``torch.Generator``; seed
    7654 when None)."""
    n2r = config.hidden_dim
    f = config.input_dim
    w_noisy = np.asarray(w_noisy, np.float32)
    if w_noisy.shape != (f, n2r):
        raise ValueError(f"w_noisy has shape {w_noisy.shape}, expected "
                         f"{(f, n2r)}")

    alph0 = np.float32(config.alph)
    if config.untie_alph:
        alph0 = alph0 * np.ones((n2r,), np.float32)

    params = {
        "log_U1": np.log(_EPS7 + np.eye(n2r, dtype=np.float32)),
        "log_Uk": np.log(_EPS7 + np.zeros((n2r, n2r), np.float32)),
        "log_W_clean": np.log(_EPS7 + w_noisy[:, : config.r].T),
        "log_W_noise": np.log(_EPS7 + w_noisy[:, config.r:].T),
    }
    if config.nonnegative:
        if generator is None:
            generator = torch.Generator().manual_seed(7654)
        u = torch.rand((n2r,), generator=generator, dtype=torch.float32)
        params["log_h0"] = (u * 0.1 - 0.05).numpy()
    else:
        params["h0"] = np.zeros((n2r,), np.float32)
    base = {
        "log_D": np.log(_EPS7 + w_noisy),
        "log_alph": np.log(_EPS7 + alph0),
        "log_lam1": np.log(np.float32(_EPS7 + config.lam1)),
    }
    for name, value in base.items():
        if name in config.params_untied:
            for k in range(config.K_layers):
                params[f"{name}_{k}"] = np.array(value, copy=True)
        else:
            params[name] = value
    return params_from_numpy(params, device)
