"""Model checkpoints: the flat parameter dict as ``.npz``, with ``__meta_``
keys for metadata -- the same file the JAX package writes and reads, so a
checkpoint moves between the two packages as it is."""

import os

import numpy as np


def _to_numpy(v):
    if hasattr(v, "detach"):  # a torch tensor, on any device
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path, params, meta=None):
    arrays = {k: _to_numpy(v) for k, v in params.items()}
    if meta:
        for k, v in meta.items():
            arrays[f"__meta_{k}"] = np.asarray(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def load_checkpoint(path):
    """-> (params: dict name -> np.ndarray, meta: dict name -> np.ndarray)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        params = {k: data[k] for k in data.files if not k.startswith("__meta_")}
        meta = {k[len("__meta_"):]: data[k]
                for k in data.files if k.startswith("__meta_")}
    return params, meta
