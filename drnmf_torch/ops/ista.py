"""ISTA for sparse NMF inference, the algorithm the DR-NMF network unfolds
(counterpart of ``drnmf_tpu/ops/ista.py``; the reference's numpy oracles,
enhance.py:385-456).

``ista_ed`` / ``ista_kl`` / ``ista_beta`` run ``n_steps`` nonnegative
soft-thresholded gradient steps on ``min_H D_beta(x, W H) + lam1 |H|_1``.
They are the ground truth of the unfolded cell at initialisation (its
layers after the first are ISTA steps) and an inference engine of their
own.  Plain functions on tensors of one device and dtype, column-major
frames: ``x`` (m, n), ``H`` (r, n), dictionary ``W`` (m, r).  No kernel
stands behind them (the JAX package runs them as XLA scans)."""

import torch


def kl_div(x, y):
    """Generalized KL divergence, elementwise (enhance.py:385-388)."""
    return (x * torch.log(1e-9 + x) - x * torch.log(1e-9 + y) - x + y)


def beta_div(x, y, beta):
    """Beta divergence, elementwise (enhance.py:391-400)."""
    if beta == 1.0:
        return kl_div(x, y)
    if beta == 0.0:
        return (x / y) - torch.log(1e-9 + x) + torch.log(1e-9 + y) - 1.0
    return (1.0 / (beta * (beta - 1.0))) * (
        x**beta + (beta - 1.0) * y**beta - beta * x * y ** (beta - 1.0))


def _ista(grad_term, x, w, h, lam1, alph, n_steps):
    for _ in range(n_steps):
        h = torch.clamp_min(
            -lam1 / alph + h + (1.0 / alph) * (w.T @ grad_term(x, w @ h)),
            0.0)
    return h


def ista_ed(x, w, h, lam1, alph, n_steps: int):
    """``n_steps`` of ISTA under Euclidean distance (enhance.py:402-418):
    ``H <- max(0, -lam1/alph + H + (1/alph) W^T (x - W H))``."""
    return _ista(lambda x, xest: x - xest, x, w, h, lam1, alph, n_steps)


def ista_kl(x, w, h, lam1, alph, n_steps: int):
    """``n_steps`` of ISTA under KL divergence (enhance.py:421-437):
    ``H <- max(0, -lam1/alph + H + (1/alph) W^T (x / (W H) - 1))``."""
    return _ista(lambda x, xest: x / xest - 1.0, x, w, h, lam1, alph,
                 n_steps)


def ista_beta(x, w, h, lam1, alph, n_steps: int, beta: float):
    """``n_steps`` of ISTA under beta divergence (enhance.py:440-456)."""
    return _ista(lambda x, xest: (x * xest ** (beta - 2.0)
                                  - xest ** (beta - 1.0)),
                 x, w, h, lam1, alph, n_steps)


def ista(x, w, h, lam1, alph, n_steps: int, beta: float = 2.0):
    """Dispatch on beta: 2 -> ED, 1 -> KL, else the generic beta step."""
    if beta == 2.0:
        return ista_ed(x, w, h, lam1, alph, n_steps)
    if beta == 1.0:
        return ista_kl(x, w, h, lam1, alph, n_steps)
    return ista_beta(x, w, h, lam1, alph, n_steps, beta)
