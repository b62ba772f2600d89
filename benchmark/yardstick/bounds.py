"""Operations and bytes of the work a cell asks for, and the least time the
card could take for it.

Frozen copies of chip_smoke.py's ``bounds_of`` (:580), ``factored_bounds``
(:595), ``train_bounds`` (:1574) and ``snmf_bounds`` (:804).  The copies
take sizes where the originals took tensors, so the count is of the work
the inputs need (the signals' own frames), whatever the program pads."""

from .peaks import PEAK_BYTES_PER_S, PEAK_TF32_FLOPS

F32 = 4


def bounds_of(flops, nbytes):
    """``bound_s``/``bound_by``: the larger of one dense TF32 tensor-core
    pass over ``flops`` and ``nbytes`` at the HBM rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_TF32_FLOPS
    return {"flops": flops, "bytes": nbytes,
            "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def factored_operand_bytes(rows, row_steps, f, n2r, k):
    """Bytes of the recurrence's operands, each read once: the input
    (``row_steps`` frames of ``f``), the step mask (one byte a row-step),
    the initial state of each row, U's fold (diag1, off1, c), the S
    factors (K-1 of F x 2r; K == 1 reads none), the input factors (K of
    F x 2r) and the biases (K of 2r)."""
    weights = (n2r + 2 + (k - 1) * n2r * f + k * f * n2r + k * n2r) * F32
    return row_steps * f * F32 + row_steps + rows * n2r * F32 + weights


def factored_bounds(rows, row_steps, f, n2r, k):
    """One B1 pass over ``row_steps`` row-steps of ``rows`` rows:
    2*F*2r*(2K-1) flops a row-step; its operands read once and the top
    layer's output (2r a row-step) written once."""
    flops = 2 * f * n2r * (2 * k - 1) * row_steps
    nbytes = (factored_operand_bytes(rows, row_steps, f, n2r, k)
              + row_steps * n2r * F32)
    return bounds_of(flops, nbytes)


def train_bounds(bsz, t_len, f, n2r, k, valid, n_trainable):
    """The parts of one train step on a (bsz, t_len, f) batch with
    ``valid`` unmasked row-steps, as ``chip_smoke.py::train_bounds`` counts
    them.  Forward: B1's operands and output, every layer's hidden state
    written.  Backward kernel: 2(K-1) products of 2*F*2r a valid row-step;
    the layer stack read, the deltas, p and gamma written, g read.  Weight
    gradients: 1 + 3(K-1) products of 2*F*2r a valid row-step.  Heads,
    loss and Adam: 3 products of 2*F*2r a valid row-step, the top layer
    and its gradient, x and y, and Adam's 7 x 4 bytes a trainable entry."""
    plane = bsz * t_len * n2r * F32
    step_bytes = bsz * t_len * f * F32
    fwd_bytes = factored_operand_bytes(bsz, bsz * t_len, f, n2r, k) + plane
    fwd = bounds_of(2 * f * n2r * (2 * k - 1) * valid, fwd_bytes + k * plane)
    weights = 2 * (k - 1) * f * n2r * F32
    bwd = bounds_of(2 * f * n2r * 2 * (k - 1) * valid,
                    2 * k * plane + plane + (k - 1) * step_bytes
                    + weights + bsz * n2r * F32)
    grads = bounds_of((1 + 3 * (k - 1)) * 2 * f * n2r * valid,
                      step_bytes + (2 * k - 1) * plane
                      + (k - 1) * step_bytes
                      + (2 * k - 1) * f * n2r * F32 + k * n2r * F32)
    heads = bounds_of(3 * 2 * f * n2r * valid,
                      2 * plane + 2 * step_bytes + 7 * F32 * n_trainable)
    return {"forward": fwd, "backward": bwd, "weight_grads": grads,
            "heads_loss_adam": heads}


def snmf_bounds(m, r, n):
    """{pass1, pass2}: one B4 and one B5 call on (m, r, n): 6 (B4) or 1
    (B5) products of 2*m*r*n flops, each input read once and each output
    written once."""
    inputs = F32 * (m * n + r * n + m * r)  # v, h, w
    out = {}
    for name, products, outputs in (
            ("pass1", 6, F32 * (r * n + 2 * m * r + 1)), ("pass2", 1, F32)):
        out[name] = bounds_of(products * 2 * m * r * n, inputs + outputs)
    return out


def drnmf_model_flops(frames, f, n2r, k):
    """The DR-NMF enhancer's operations for ``frames`` frames: the
    recurrence's 2*F*2r*(2K-1) a frame and the two heads' 2*F*2r."""
    return 2 * f * n2r * 2 * k * frames


def snmf_model_flops(frames, f, n2r, iters):
    """The SNMF enhancer's operations for ``frames`` frames with W frozen:
    W^T v once, W h and W^T (W h) each iteration, and the two
    reconstructions of the mask, each 2*F*2r a frame (or 2*F*r twice)."""
    return 2 * f * n2r * (1 + 2 * iters + 1) * frames


def train_model_flops(parts):
    """A train step's operations: the sum over ``train_bounds``' parts."""
    return sum(p["flops"] for p in parts.values())
