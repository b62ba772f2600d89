"""Hash-keyed artifact cache for SNMF dictionaries.

Counterpart of ``drnmf_tpu/utils/cache.py`` (the reference's hickle cache,
enhance.py:29-78): dictionaries are stored under
``W_{clean|noisy}_<md5(params)>_sparsity<s>.npz`` and reruns load instead
of recompute.  The same ``SNMFParams`` give the same file name in both
packages, so either one reuses the other's dictionaries.
"""

import os
from dataclasses import asdict

import numpy as np

from ..config import config_hash

# initial values and update masks: how a run starts, not what it learns
_NOT_IDENTITY = ("init_w", "init_h", "w_update_ind", "h_update_ind")


def snmf_cache_path(params_snmf, path_dicts="", prefix="noisy"):
    digest = config_hash(asdict(params_snmf), exclude=_NOT_IDENTITY)
    sparsity = float(np.asarray(params_snmf.sparsity).ravel()[0])
    return os.path.join(path_dicts,
                        f"W_{prefix}_{digest}_sparsity{sparsity:.3f}.npz")


def save_snmf(path, w, h, obj, save_h=True):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {"W": w, "div": obj["div"], "cost": obj["cost"]}
    if save_h and h is not None:
        arrays["H"] = h
    np.savez(path, **arrays)


def load_snmf(path, load_h=True):
    with np.load(path) as data:
        w = data["W"]
        h = data["H"] if (load_h and "H" in data.files) else None
        obj = {"div": data["div"], "cost": data["cost"]}
    return w, h, obj
