"""Kernel B1: the folded + factored DR-NMF recurrence on an H100.

Replaces ``drnmf_tpu/ops/pallas/drnmf_scan.py::_kernel_factored`` (entry
``drnmf_scan_pallas_factored``).  The kernel is CUDA C++ in
``csrc/drnmf_scan_factored.cu``, built for ``sm_90a`` at first use (see
``build.py``).

What bounds it on the card: per batch row and step it does 2·F·2r·(2K−1)
flops against about one byte of compulsory traffic per flop, so the f32 rate
of the CUDA cores bounds it.  What the design does about it: one launch runs
the whole scan; blocks split the batch (two rows each, no inter-block
synchronisation), keep the carry, hidden state and residual in shared memory
and stream the weights from L2.  Every block re-reads the weight stack at
every step, so this first version is bound by L2 bandwidth; the source note
in the ``.cu`` file gives the trade-off.

``drnmf_scan_factored`` is the wrapper: for CUDA tensors it launches the
kernel or raises; for CPU tensors it runs the plain version
``drnmf_scan_factored_reference``, which is the same function in eager
PyTorch and the reference the kernel is held against.
"""

import ctypes
import functools

import torch

from . import build

SOURCE = "drnmf_scan_factored.cu"
# kernel launches since the last reset; chip_smoke.py reads it to show that
# the main path went through the kernel
LAUNCHES = 0


@functools.cache
def _library():
    lib = build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.drnmf_scan_factored.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
    lib.drnmf_scan_factored.restype = i32
    lib.drnmf_cuda_error_string.argtypes = [i32]
    lib.drnmf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def drnmf_scan_factored_reference(x, step_mask, h0, diag1, off1, c_uk,
                                  dkt_stack, dka_stack, b_stack):
    """Plain PyTorch version of the kernel, in the arithmetic order of
    ``models.drnmf.u_terms``/``layer_pre``.  Arguments as for
    :func:`drnmf_scan_factored`."""
    k_layers = dka_stack.shape[0]
    h = h0
    outs = []
    for t in range(x.shape[1]):
        x_t = x[:, t]
        rs = h.sum(dim=1, keepdim=True)
        hidden = torch.relu(h * (diag1 - off1) + off1 * rs
                            + x_t @ dka_stack[0] + b_stack[0])
        for k in range(1, k_layers):
            resid = x_t - hidden @ dkt_stack[k - 1]
            hidden = torch.relu(c_uk * rs + hidden + resid @ dka_stack[k]
                                + b_stack[k])
        h = torch.where(step_mask[:, t, None], hidden, h)
        outs.append(h)
    if not outs:
        return x.new_empty((x.shape[0], 0, h0.shape[-1]))
    return torch.stack(outs, dim=1)


def _check(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def drnmf_scan_factored(x, step_mask, h0, diag1, off1, c_uk, dkt_stack,
                        dka_stack, b_stack):
    """Folded + factored recurrence over the whole sequence.

    x (B, T, F) f32; step_mask (B, T) bool (True = valid step); h0 (B, 2r);
    diag1 (2r,); off1, c_uk 0-dim or 1-element f32 tensors;
    dkt_stack (K-1, 2r, F) = Dhat_k^T (a dummy (1, 2r, F) when K == 1);
    dka_stack (K, F, 2r) = Dhat_k/alph_k; b_stack (K, 2r).
    Returns the hidden states (B, T, 2r) f32; masked steps hold the carry.
    """
    global LAUNCHES
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, F), got {tuple(x.shape)}")
    bsz, t_len, f = x.shape
    n2r = h0.shape[-1]
    k_layers = dka_stack.shape[0]
    if k_layers < 1:
        raise ValueError("dka_stack must hold at least one layer")
    dev = x.device
    f32 = torch.float32
    off1 = off1.reshape(1) if isinstance(off1, torch.Tensor) else off1
    c_uk = c_uk.reshape(1) if isinstance(c_uk, torch.Tensor) else c_uk
    for name, t, shape, dtype in [
            ("x", x, (bsz, t_len, f), f32),
            ("step_mask", step_mask, (bsz, t_len), torch.bool),
            ("h0", h0, (bsz, n2r), f32),
            ("diag1", diag1, (n2r,), f32),
            ("off1", off1, (1,), f32),
            ("c_uk", c_uk, (1,), f32),
            ("dkt_stack", dkt_stack, (max(1, k_layers - 1), n2r, f), f32),
            ("dka_stack", dka_stack, (k_layers, f, n2r), f32),
            ("b_stack", b_stack, (k_layers, n2r), f32)]:
        _check(name, t, shape, dtype, dev)

    if dev.type == "cpu":
        return drnmf_scan_factored_reference(
            x, step_mask, h0, diag1, off1, c_uk, dkt_stack, dka_stack,
            b_stack)
    if dev.type != "cuda":
        raise ValueError(f"drnmf_scan_factored runs on cuda or cpu, not {dev}")

    out = torch.empty((bsz, t_len, n2r), dtype=f32, device=dev)
    if bsz == 0 or t_len == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.drnmf_scan_factored(
            x.data_ptr(), step_mask.data_ptr(), h0.data_ptr(),
            diag1.data_ptr(), off1.data_ptr(), c_uk.data_ptr(),
            dkt_stack.data_ptr(), dka_stack.data_ptr(), b_stack.data_ptr(),
            out.data_ptr(), bsz, t_len, f, n2r, k_layers, stream)
    if err != 0:
        msg = lib.drnmf_cuda_error_string(err).decode()
        raise RuntimeError(f"drnmf_scan_factored launch failed: {msg} "
                           f"(B={bsz}, T={t_len}, F={f}, 2r={n2r}, "
                           f"K={k_layers})")
    LAUNCHES += 1
    return out
