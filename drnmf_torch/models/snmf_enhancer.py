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
from ..utils.profiling import count, span


def snmf_infer_irm(x_frames, w_noisy, params_snmf: SNMFParams,
                   max_iter: int = 200, frame_chunk=None, generator=None,
                   device="cuda"):
    """Infer activations for noisy frames under a frozen dictionary and
    compute the ratio mask.

    x_frames: (F, n_frames) nonnegative magnitudes (numpy or a tensor).
    w_noisy:  (F, 2r) = [W_clean, W_noise].
    ``generator``: for the random initial H (see ``ops.snmf.sparse_nmf``).
    Returns ``(irm, h)``: the mask as a numpy (F, n_frames) array and H as
    a (2r, n_frames) tensor.  The mask is built on the device from each
    frame chunk's H as the solve leaves it, and only the mask is fetched.
    Where the frames are one chunk, H is the solve's own tensor on the
    device (``h.cpu().numpy()`` reads it on the host); over several, the
    chunks' H are gathered into a host tensor, so the device holds one
    chunk's at a time.  Traced, the call is the span ``snmf.call`` over
    ``snmf.mask_to_host`` a chunk, and over several chunks
    ``snmf.h_to_host`` a chunk; the counter ``snmf.h_kept_on_device``
    adds the frames whose H never left the device.
    """
    with span("snmf.call", frames=int(x_frames.shape[1])):
        device = resolve_device(device)
        w_noisy = np.asarray(w_noisy, np.float32)
        r2 = w_noisy.shape[1]
        r = r2 // 2
        n = int(x_frames.shape[1])
        infer_params = replace(params_snmf, r=r2, init_w=w_noisy,
                               w_update_ind=np.zeros(r2, bool), conv_eps=0.0,
                               max_iter=max_iter)
        w = torch.from_numpy(w_noisy).to(device)
        masks, h_host = [], None

        def take_h(cols, h):
            nonlocal h_host
            clean_est = w[:, :r] @ h[:r]
            noise_est = w[:, r:] @ h[r:]
            irm = clean_est / (1e-9 + clean_est + noise_est)
            with span("snmf.mask_to_host"):
                masks.append(irm.cpu().numpy())
            if h.shape[1] == n:
                count("snmf.h_kept_on_device", n)
                return
            if h_host is None:
                h_host = torch.empty((r2, n), dtype=torch.float32)
            with span("snmf.h_to_host"):
                h_host[:, cols] = h.cpu()

        res = sparse_nmf_chunked(x_frames, infer_params, generator=generator,
                                 frame_chunk=frame_chunk, device=device,
                                 take_h=take_h)
        irm = masks[0] if len(masks) == 1 else np.concatenate(masks, axis=1)
        return irm, res.h if res.h is not None else h_host
