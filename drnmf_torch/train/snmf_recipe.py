"""Two-stage SNMF dictionary training recipe.

Counterpart of ``drnmf_tpu/train/snmf_recipe.py`` (the reference's
``train_snmf``, enhance.py:81-135):

1. SNMF on *clean* magnitude frames -> speech dictionary W_clean (r atoms,
   unit-L2 columns);
2. SNMF on *noisy* frames with ``init_w = [W_clean, rand]`` and
   ``w_update_ind = [0...0, 1...1]``, so only the noise half learns;
3. both stages cached under ``utils.cache.snmf_cache_path`` (md5 of the
   params), the same file names as the JAX package's.

Returns the concatenated dictionary W_noisy = [W_clean, W_noise].
"""

import os
from dataclasses import replace

import numpy as np
import torch

from ..device import resolve_device
from ..ops.snmf import SNMFParams, sparse_nmf_chunked
from ..utils.cache import load_snmf, save_snmf, snmf_cache_path


def noise_half(shape, seed):
    """The noise half's initial values: uniform [0, 1) float32 from a CPU
    ``torch.Generator`` seeded with ``seed`` (the JAX package draws them
    from ``PRNGKey(seed)``; the numbers differ, the law is the same)."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.rand(shape, generator=g, dtype=torch.float32).numpy()


def train_snmf(clean_frames, noisy_frames, params_snmf: SNMFParams,
               path_dicts="./", save_h=False, flag_recompute=False,
               verbose=True, frame_chunk=None, device="cuda"):
    """Frames: (F, n) nonnegative, numpy or tensors.  Returns
    ``(w_noisy (F, 2r), h_noisy or None, {"div": ..., "cost": ...})``
    (numpy)."""
    device = resolve_device(device)
    r = int(params_snmf.r)

    # stage 1: clean-speech dictionary
    clean_path = snmf_cache_path(params_snmf, path_dicts, prefix="clean")
    if os.path.exists(clean_path) and not flag_recompute:
        if verbose:
            print(f"Loading cached clean SNMF dictionary {clean_path}")
        w_clean, _, _ = load_snmf(clean_path, load_h=False)
    else:
        if verbose:
            sp = float(np.ravel(params_snmf.sparsity)[0])
            print(f"Training SNMF (sparsity {sp:.3f}) on clean frames...")
        res = sparse_nmf_chunked(clean_frames, params_snmf,
                                 frame_chunk=frame_chunk, save_h=save_h,
                                 verbose=verbose, device=device)
        w_clean = res.w
        save_snmf(clean_path, res.w, res.h,
                  {"div": res.div, "cost": res.cost}, save_h=save_h)

    # stage 2: noisy dictionary with the speech half frozen
    noisy_path = snmf_cache_path(params_snmf, path_dicts, prefix="noisy")
    if os.path.exists(noisy_path) and not flag_recompute:
        if verbose:
            print(f"Loading cached noisy SNMF dictionary {noisy_path}")
        return load_snmf(noisy_path, load_h=save_h)

    if verbose:
        print("Training SNMF on noisy frames (speech half frozen)...")
    w_init = np.concatenate(
        [w_clean, noise_half(w_clean.shape, int(params_snmf.random_seed) + 1)],
        axis=1)
    idx_update = np.concatenate([np.zeros(r, bool), np.ones(r, bool)])
    params_noisy = replace(params_snmf, r=2 * r, init_w=w_init,
                           w_update_ind=idx_update)
    res = sparse_nmf_chunked(noisy_frames, params_noisy,
                             frame_chunk=frame_chunk, save_h=save_h,
                             verbose=verbose, device=device)
    obj = {"div": res.div, "cost": res.cost}
    save_snmf(noisy_path, res.w, res.h, obj, save_h=save_h)
    return res.w, res.h, obj
