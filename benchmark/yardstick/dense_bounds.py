"""Operations and bytes of DR-NMF with dense U (kernel B3), and the least
time the card could take for a launch.

Ported from chip_smoke.py's ``b3_flops`` (:634) and ``b3_bounds`` (:642).
As in ``bounds.py``, the port takes sizes where the originals took
tensors, and counts the work the inputs need: the signals' own frames,
and the steps of the longest of them."""

from .bounds import F32, bounds_of

L2_BYTES = 50 * 2 ** 20  # H100 SXM L2 (50 MiB); chip_smoke.py:303


def dense_step_flops(f, n2r, k):
    """B3's operations a row-step: 2*(2r)^2*(2K-1) + 2*F*2r*K (h @ U_k in
    every layer, hid @ S_{k-1} in all but the first, x_t @ W_k in every
    layer)."""
    return 2 * n2r * n2r * (2 * k - 1) + 2 * f * n2r * k


def dense_weight_bytes(f, n2r, k):
    """Bytes of B3's weights: u1, uk (K == 1 reads none), K-1 S matrices,
    K W matrices and K biases."""
    matrices = 1 + (k > 1) + (k - 1)
    return (matrices * n2r * n2r + k * f * n2r + k * n2r) * F32


def dense_bounds(rows, steps, row_steps, f, n2r, k):
    """One B3 launch over ``rows`` rows and ``steps`` steps, of which
    ``row_steps`` row-steps are the signals' own frames.  Operations: one
    dense TF32 pass of ``dense_step_flops`` a row-step.  Bytes: the input
    and the step mask of those row-steps, each row's initial state and the
    weights read once, the output written once, and the weights' bytes
    past the L2 read again at every step after the first (they fit no
    cache)."""
    weights = dense_weight_bytes(f, n2r, k)
    nbytes = (row_steps * (f * F32 + 1 + n2r * F32) + rows * n2r * F32
              + weights + (steps - 1) * max(0, weights - L2_BYTES))
    return bounds_of(dense_step_flops(f, n2r, k) * row_steps, nbytes)


def dense_model_flops(frames, f, n2r, k):
    """The dense-U enhancer's operations for ``frames`` frames: B3's a
    frame and the two heads' 2*F*2r."""
    return (dense_step_flops(f, n2r, k) + 2 * f * n2r) * frames
