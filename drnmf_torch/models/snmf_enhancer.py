"""SNMF-only enhancement (no learned unfolding).

Counterpart of ``drnmf_tpu/models/snmf_enhancer.py`` (the reference's 'snmf'
model branch, enhance.py:750-928): activations by multiplicative updates
with W frozen (w_update_ind all False, max_iter=200, conv_eps=0), then the
Wiener-style ratio mask ``irm = W_c H_c / (1e-9 + W_c H_c + W_n H_n)``
(enhance.py:847-852).  The updates run on kernels B4/B5 on the card.
"""

from dataclasses import replace

import numpy as np
import torch

from ..device import resolve_device
from ..ops.snmf import SNMFParams, sparse_nmf_chunked


def snmf_infer_irm(x_frames, w_noisy, params_snmf: SNMFParams,
                   max_iter: int = 200, frame_chunk=None, generator=None,
                   device="cuda"):
    """Infer activations for noisy frames under a frozen dictionary and
    compute the ratio mask.

    x_frames: (F, n_frames) nonnegative magnitudes (numpy or a tensor).
    w_noisy:  (F, 2r) = [W_clean, W_noise].
    ``generator``: for the random initial H (see ``ops.snmf.sparse_nmf``).
    Returns numpy ``(irm (F, n_frames), h (2r, n_frames))``.
    """
    device = resolve_device(device)
    w_noisy = np.asarray(w_noisy, np.float32)
    r2 = w_noisy.shape[1]
    r = r2 // 2
    infer_params = replace(params_snmf, r=r2, init_w=w_noisy,
                           w_update_ind=np.zeros(r2, bool), conv_eps=0.0,
                           max_iter=max_iter)
    res = sparse_nmf_chunked(x_frames, infer_params, generator=generator,
                             frame_chunk=frame_chunk, device=device)
    h = torch.from_numpy(res.h).to(device)
    w = torch.from_numpy(w_noisy).to(device)
    clean_est = w[:, :r] @ h[:r]
    noise_est = w[:, r:] @ h[r:]
    irm = clean_est / (1e-9 + clean_est + noise_est)
    return irm.cpu().numpy(), res.h
