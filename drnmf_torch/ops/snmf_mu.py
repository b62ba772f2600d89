"""Kernels B4 and B5: the MU passes of sparse NMF under the ED objective.

Replaces ``drnmf_tpu/ops/pallas/snmf_mu.py::_pass1_kernel`` (B4) and
``::_pass2_kernel`` (B5).  Both kernels are CUDA C++ in
``csrc/snmf_mu.cu``, built for ``sm_90a`` at first use (see ``build.py``).

What bounds them on the card: B4 is six products of 2·m·r·n flops, B5 one,
against about one byte of compulsory traffic per 400 flops at the
dictionary's shape (m=257, r=2000), so the f32 rate of the CUDA cores
bounds both.  What the design does about it: one tiled f32 product kernel
with an epilogue per use (the ``.cu`` file's note), per-block partials and
fixed-order sums in place of the TPU's sequential-grid accumulators, so a
run is reproducible bit for bit.

``snmf_mu_pass1`` and ``snmf_mu_pass2`` are the wrappers: for CUDA tensors
they launch the kernel or raise; for CPU tensors they run the plain
versions ``snmf_mu_pass1_reference`` / ``snmf_mu_pass2_reference``.
``mu_ed_iteration`` and ``sparse_nmf_ed`` are the solver around them
(``_mu_ed_iteration`` and ``sparse_nmf_ed_pallas`` in the JAX package): the
(m, r) W update between the passes is plain PyTorch.
"""

import ctypes
import functools

import torch

from . import build

SOURCE = "snmf_mu.cu"
# kernel launches since the last reset, one per wrapper call that launched;
# chip_smoke.py reads them to show that the main path went through B4/B5
LAUNCHES = {"pass1": 0, "pass2": 0}
FLR = 1e-9


@functools.cache
def _library():
    lib = build.load(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.snmf_mu_pass1_workspace.argtypes = [i32, i32, i64]
    lib.snmf_mu_pass1_workspace.restype = i64
    lib.snmf_mu_pass2_workspace.argtypes = [i32, i32, i64]
    lib.snmf_mu_pass2_workspace.restype = i64
    lib.snmf_mu_pass1.argtypes = ([ptr] * 3 + [ctypes.c_float] + [ptr] * 5
                                  + [i32, i32, i64, ptr])
    lib.snmf_mu_pass1.restype = i32
    lib.snmf_mu_pass2.argtypes = [ptr] * 5 + [i32, i32, i64, ptr]
    lib.snmf_mu_pass2.restype = i32
    lib.snmf_mu_error_string.argtypes = [i32]
    lib.snmf_mu_error_string.restype = ctypes.c_char_p
    return lib


def snmf_mu_pass1_reference(v, h, w, sparsity):
    """Plain PyTorch version of B4, in the arithmetic order of
    ``_pass1_kernel``.  Arguments and result as for :func:`snmf_mu_pass1`."""
    lam = (w @ h).clamp_min(FLR)
    numer = w.T @ v
    denom = w.T @ lam + sparsity
    h_new = h * numer / denom.clamp_min(FLR)
    lam2 = (w @ h_new).clamp_min(FLR)
    return h_new, v @ h_new.T, lam2 @ h_new.T, sparsity * h_new.sum()


def snmf_mu_pass2_reference(v, h, w):
    """Plain PyTorch version of B5: ``sum((v - max(w @ h, flr))**2)``."""
    return ((v - (w @ h).clamp_min(FLR)) ** 2).sum()


def _check_operands(v, h, w):
    """(m, r, n) of v (m, n), h (r, n), w (m, r); raises on anything the
    kernels do not take."""
    for name, t in (("v", v), ("w", w)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
    (m, n), r = v.shape, w.shape[1]
    for name, t, shape in (("v", v, (m, n)), ("h", h, (r, n)),
                           ("w", w, (m, r))):
        build.check_operand(name, t, shape, torch.float32, v.device)
    if max(m, r, n) >= 2**31:
        raise ValueError("each dimension must be below 2**31")
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"runs on cuda or cpu, not {v.device}")
    return m, r, n


def _raise_on(err, lib, name, m, r, n):
    if err != 0:
        msg = lib.snmf_mu_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (m={m}, r={r}, "
                           f"n={n})")


def snmf_mu_pass1(v, h, w, sparsity):
    """Kernel B4, one H-update pass and the W-update statistics.

    v (m, n), h (r, n), w (m, r): float32, contiguous, one device;
    ``sparsity``: a Python number (the scalar L1 weight).  Returns
    ``(h_new (r, n), a (m, r), b (m, r), sp_sum)`` with
    ``h_new = h * (w.T v) / max(w.T max(w h, flr) + sparsity, flr)``,
    ``a = v h_new.T``, ``b = max(w h_new, flr) h_new.T`` and
    ``sp_sum = sparsity * sum(h_new)`` (a 0-dim tensor)."""
    m, r, n = _check_operands(v, h, w)
    if isinstance(sparsity, bool) or not isinstance(sparsity, (int, float)):
        raise TypeError("sparsity must be a Python number (B4 takes a "
                        "scalar sparsity)")
    if v.device.type == "cpu":
        return snmf_mu_pass1_reference(v, h, w, float(sparsity))

    h_new = torch.empty_like(h)
    a = torch.empty((m, r), dtype=torch.float32, device=v.device)
    b = torch.empty_like(a)
    sp_sum = torch.zeros((), dtype=torch.float32, device=v.device)
    if min(m, r, n) == 0:
        return h_new, a.zero_(), b.zero_(), sp_sum
    lib = _library()
    ws = torch.empty(lib.snmf_mu_pass1_workspace(m, r, n),
                     dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.snmf_mu_pass1(
            v.data_ptr(), h.data_ptr(), w.data_ptr(), float(sparsity),
            h_new.data_ptr(), a.data_ptr(), b.data_ptr(), sp_sum.data_ptr(),
            ws.data_ptr(), m, r, n, stream)
    _raise_on(err, lib, "snmf_mu_pass1", m, r, n)
    LAUNCHES["pass1"] += 1
    return h_new, a, b, sp_sum


def snmf_mu_pass2(v, h, w):
    """Kernel B5, the ED divergence ``sum((v - max(w h, flr))**2)`` as a
    0-dim tensor.  Operands as for :func:`snmf_mu_pass1`."""
    m, r, n = _check_operands(v, h, w)
    if v.device.type == "cpu":
        return snmf_mu_pass2_reference(v, h, w)

    div = torch.zeros((), dtype=torch.float32, device=v.device)
    if m == 0 or n == 0:
        return div
    lib = _library()
    ws = torch.empty(lib.snmf_mu_pass2_workspace(m, r, n),
                     dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.snmf_mu_pass2(v.data_ptr(), h.data_ptr(), w.data_ptr(),
                                div.data_ptr(), ws.data_ptr(), m, r, n,
                                stream)
    _raise_on(err, lib, "snmf_mu_pass2", m, r, n)
    LAUNCHES["pass2"] += 1
    return div


PLAIN_PASSES = (snmf_mu_pass1_reference, snmf_mu_pass2_reference)


def mu_ed_iteration(v, h, w, sparsity, w_mask, passes=None):
    """One MU iteration: B4, the normalization-aware W update with column
    renorm (sparse_nmf_gpu.m:232-264; plain PyTorch on (m, r) tensors),
    then B5 on the new W.  ``w_mask`` (r,) bool: the columns that update.
    ``passes``: a (pass1, pass2) pair in place of the kernels (the plain
    versions, :data:`PLAIN_PASSES`, for a parity run).
    Returns ``(h_new, w_new, div, cost)``; div and cost are 0-dim tensors."""
    pass1, pass2 = passes or (snmf_mu_pass1, snmf_mu_pass2)
    h_new, a, b, sp_sum = pass1(v, h, w, sparsity)
    dpw = b + (a * w).sum(dim=0, keepdim=True) * w
    dmw = a + (b * w).sum(dim=0, keepdim=True) * w
    w_new = w * dmw / dpw.clamp_min(FLR)
    w_new = torch.where(w_mask[None, :], w_new, w)
    # like the TPU solver, renormalises every column, frozen ones included
    w_new = w_new / (w_new * w_new).sum(dim=0, keepdim=True).sqrt()
    div = pass2(v, h_new, w_new)
    return h_new, w_new, div, div + sp_sum


def sparse_nmf_ed(v, w0, h0, sparsity, w_mask, max_iter, conv_eps,
                  passes=None):
    """Full ED sparse NMF with the MU passes (``sparse_nmf_ed_pallas``).

    v (m, n), w0 (m, r), h0 (r, n) float32 tensors on one device;
    ``sparsity`` a Python number; ``w_mask`` (r,) bool tensor.  Normalises
    W's columns and rescales H to match, then iterates until ``max_iter``
    or, when ``conv_eps > 0``, until the cost moves by less than
    ``conv_eps`` relative to the last (one host read per iteration, only
    then).  ``passes``: see :func:`mu_ed_iteration`.
    Returns ``(w, h, divs, costs, n_iter)``; divs and costs hold the
    ``n_iter`` iterations run."""
    wn = (w0 * w0).sum(dim=0).sqrt()
    w = (w0 / wn[None, :]).contiguous()
    h = (h0 * wn[:, None]).contiguous()
    v = v.contiguous()
    divs, costs = [], []
    for it in range(max_iter):
        h, w, div, cost = mu_ed_iteration(v, h, w, sparsity, w_mask, passes)
        divs.append(div)
        costs.append(cost)
        if converged(costs, conv_eps):
            break
    return w, h, history(divs, v), history(costs, v), len(costs)


def converged(costs, conv_eps):
    """The relative-cost stop (sparse_nmf_gpu.m): after the first
    iteration, ``|cost - last| / last < conv_eps`` in f32.  Reads the
    device once, and only when ``conv_eps > 0``."""
    if conv_eps <= 0 or len(costs) < 2:
        return False
    cost, last = costs[-1], costs[-2]
    return bool(((cost - last).abs() / last < conv_eps).item())


def history(values, like):
    """The per-iteration 0-dim tensors as one 1-D tensor (empty for none)."""
    return torch.stack(values) if values else like.new_zeros((0,))
