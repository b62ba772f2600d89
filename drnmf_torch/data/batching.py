"""Batching glue (counterpart of part of ``drnmf_tpu/data/batching.py``)."""

import torch


def masked_seqs_to_frames(x, mask):
    """(B, T, F) sequences + (B, T, 1) binary mask -> (F, n_valid) frame
    matrix, frames in (b, t) order.  Tensors (on any device) or arrays;
    the result is a tensor on ``x``'s device."""
    x = torch.as_tensor(x)
    mask = torch.as_tensor(mask).to(x.device)
    b, t, f = x.shape
    flat = x.permute(2, 0, 1).reshape(f, b * t)
    mflat = mask.permute(2, 0, 1).reshape(b * t)
    return flat[:, mflat > 0]
