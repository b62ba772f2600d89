"""The sparse-NMF enhancer (Le Roux, Hershey and Weninger's sparse NMF,
MERL TR2015-023, with the Euclidean cost) with the dictionary frozen:
multiplicative updates of the activations,

    h <- h * (W^T v) / max(W^T max(W h, flr) + sparsity, flr),  flr = 1e-9,

after W's columns are normalised and h rescaled to match, then the mask
W_c h_c / (1e-9 + W_c h_c + W_n h_n).  Each frame's activations depend
only on that frame, so the reference runs the frames it checks and no
others.  Departure from the program: W^T v is computed once, not every
iteration, and the statistics of W, which a frozen W does not use, are
not computed."""

import torch

from .precision import mm, no_tf32

FLR = 1e-9


def infer(v, w, h0, sparsity, iters, precision="f32"):
    """v (F, n) magnitudes, w (F, 2r), h0 (2r, n) -> the activations h."""
    no_tf32()
    wn = torch.sqrt((w * w).sum(dim=0))
    w = w / wn[None, :]
    h = h0 * wn[:, None]
    wtv = mm(w.T, v, precision)
    for _ in range(iters):
        lam = mm(w, h, precision).clamp_min(FLR)
        h = h * wtv / (mm(w.T, lam, precision) + sparsity).clamp_min(FLR)
    return h


def ratio_mask(w, h, precision="f32"):
    """The mask of the dictionary ``w`` (F, 2r) as given and the
    activations ``h`` (2r, n)."""
    r = w.shape[1] // 2
    clean = mm(w[:, :r], h[:r], precision)
    noise = mm(w[:, r:], h[r:], precision)
    return clean / (1e-9 + clean + noise)
