"""Kernels B4 and B5: the MU passes of sparse NMF under the ED objective.

Replaces ``drnmf_tpu/ops/pallas/snmf_mu.py::_pass1_kernel`` (B4) and
``::_pass2_kernel`` (B5).  Both kernels are CUDA C++ in
``csrc/snmf_mu.cu``, built for ``sm_90a`` at first use (see ``build.py``).

What bounds them on the card: B4 is six products of 2*m*r*n flops, B5 one,
against about one byte of compulsory traffic per 400 flops at the
dictionary's shape (m=257, r=2000).  One TF32 tensor-core pass bounds B4
by operations; B5's bytes bound it.  What the design does about it: one
tensor-core product mainloop (``wgmma`` on TF32 operands split into a head
and a tail, three products a term, so the result keeps f32-class accuracy;
a ring of ``cp.async`` stages; the frames on the instruction's M axis and
m = 257 on its N axis) with an epilogue per use, per-block partials and
fixed-order sums in place of the TPU's sequential-grid accumulators, so a
run is reproducible bit for bit.  The tensor cores sum short chains only;
the chains are added in f32 on the CUDA cores, because the tensor cores'
own accumulation rounds toward zero.  The ``.cu`` file's note has the rest.

``snmf_mu_pass1`` and ``snmf_mu_pass2`` are the wrappers: for CUDA tensors
they launch the kernel or raise; for CPU tensors they run the plain
versions ``snmf_mu_pass1_reference`` / ``snmf_mu_pass2_reference``.  What a
wrapper prepares for its kernel is W with its rows zero-padded to a
multiple of four floats (:func:`pad_rows`; 16-byte copies need it) and, for
B4, the same of W^T and of v.  :func:`tf32_split` is the split the kernels
do in registers and shared memory, kept here for the tests.
``mu_ed_iteration`` and ``sparse_nmf_ed`` are the solver around them
(``_mu_ed_iteration`` and ``sparse_nmf_ed_pallas`` in the JAX package): the
(m, r) W update between the passes is plain PyTorch.

With no column of W to update (``snmf_infer_irm``: the whole dictionary
frozen) the solver takes its own route, by that rule alone: W^T v once a
solve (:func:`snmf_mu_frozen_init`), then each iteration B4 as the H update alone
(:func:`snmf_mu_frozen_pass1`) and B5 writing lam = max(W h', flr) for the
next iteration beside the divergence (:func:`snmf_mu_frozen_pass2`).  That
is two products an iteration where the general route runs seven, each
value that is read computed by the same product in the same order.
"""

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from ..utils.profiling import count
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
    lib.snmf_mu_pass1.argtypes = ([ptr] * 4 + [ctypes.c_float] + [ptr] * 5
                                  + [i32, i32, i64, ptr])
    lib.snmf_mu_pass1.restype = i32
    lib.snmf_mu_pass2.argtypes = [ptr] * 5 + [i32, i32, i64, ptr]
    lib.snmf_mu_pass2.restype = i32
    lib.snmf_mu_frozen_pass1_workspace.argtypes = [i32, i32, i64]
    lib.snmf_mu_frozen_pass1_workspace.restype = i64
    lib.snmf_mu_frozen_init.argtypes = [ptr] * 6 + [i32, i32, i64, ptr]
    lib.snmf_mu_frozen_init.restype = i32
    lib.snmf_mu_frozen_pass1.argtypes = ([ptr] * 4 + [ctypes.c_float]
                                         + [ptr] * 3 + [i32, i32, i64, ptr])
    lib.snmf_mu_frozen_pass1.restype = i32
    lib.snmf_mu_frozen_pass2.argtypes = [ptr] * 6 + [i32, i32, i64, ptr]
    lib.snmf_mu_frozen_pass2.restype = i32
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


class FrozenW:
    """What the MU iterations of a solve with the whole of W frozen carry
    from one to the next: ``numer`` = W^T v (r, n); ``lam`` = max(W h, flr)
    of the ``h`` the next iteration starts from, (m, n), on the card
    (m, n_pad) with its rows padded with flr to a multiple of four frames;
    ``w_pad`` and ``wt_pad``, W and W^T as the passes take them.  Empty
    until :func:`snmf_mu_frozen_init` fills it; it then holds the very
    tensors ``v``, ``w`` and ``h`` it was made from, and
    :func:`snmf_mu_frozen_pass2` moves it on to its ``h``."""

    def __init__(self):
        self.v = self.w = self.h = None
        self.numer = self.lam = self.w_pad = self.wt_pad = None
        self._versions = None

    def made_from(self, v, h, w):
        self.v, self.w = v, w
        self.moved_to(h)

    def moved_to(self, h):
        self.h = h
        self._versions = (self.v._version, h._version, self.w._version)

    def holds(self, v, h, w):
        """Whether the state is that of these tensors (the same objects,
        none changed in place since): only then does a pass on it compute
        the h' of the general route."""
        return (self._versions is not None and self.v is v and self.h is h
                and self.w is w
                and self._versions == (v._version, h._version, w._version))

    def require(self, h):
        if not self.holds(self.v, h, self.w):
            raise ValueError("the frozen state holds lam of another h, or "
                             "none: snmf_mu_frozen_init first")


def snmf_mu_frozen_init_reference(v, h, w, frozen):
    """Plain PyTorch version of :func:`snmf_mu_frozen_init`."""
    frozen.numer = w.T @ v
    frozen.lam = (w @ h).clamp_min(FLR)
    frozen.w_pad, frozen.wt_pad = w, w.T
    frozen.made_from(v, h, w)


def snmf_mu_frozen_pass1_reference(h, sparsity, frozen):
    """Plain PyTorch version of the frozen route's B4.  Arguments and
    result as for :func:`snmf_mu_frozen_pass1`."""
    frozen.require(h)
    denom = frozen.wt_pad @ frozen.lam + sparsity
    h_new = h * frozen.numer / denom.clamp_min(FLR)
    return h_new, sparsity * h_new.sum()


def snmf_mu_frozen_pass2_reference(v, h, frozen):
    """Plain PyTorch version of the frozen route's B5.  Arguments and
    result as for :func:`snmf_mu_frozen_pass2`."""
    frozen.lam = (frozen.w_pad @ h).clamp_min(FLR)
    frozen.moved_to(h)
    return ((v - frozen.lam) ** 2).sum()


def tf32_split(x):
    """``(hi, lo)`` with ``hi`` the TF32 rounding of float32 ``x`` (10
    mantissa bits, to nearest, ties away from zero: the low 13 bits zero)
    and ``lo = x - hi``, exact in float32.  The kernels split every operand
    of a product so and sum ``a_lo*b_hi + a_hi*b_lo + a_hi*b_hi``."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, x - hi


def pad_rows(x, multiple=4):
    """2-D ``x`` with each row zero-padded to a multiple of ``multiple``
    entries, contiguous; ``x`` itself when nothing is to pad."""
    rows, cols = x.shape
    padded = -(-cols // multiple) * multiple
    if padded == cols and x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    out = x.new_zeros((rows, padded))
    out[:, :cols] = x
    return out


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
    v_pad, w_pad, wt_pad = pad_rows(v), pad_rows(w), pad_rows(w.T)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.snmf_mu_pass1(
            v_pad.data_ptr(), h.data_ptr(), w_pad.data_ptr(),
            wt_pad.data_ptr(), float(sparsity), h_new.data_ptr(),
            a.data_ptr(), b.data_ptr(), sp_sum.data_ptr(), ws.data_ptr(),
            m, r, n, stream)
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
    w_pad = pad_rows(w)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.snmf_mu_pass2(v.data_ptr(), h.data_ptr(), w_pad.data_ptr(),
                                div.data_ptr(), ws.data_ptr(), m, r, n,
                                stream)
    _raise_on(err, lib, "snmf_mu_pass2", m, r, n)
    LAUNCHES["pass2"] += 1
    return div


def snmf_mu_frozen_init(v, h, w, frozen):
    """Fills ``frozen`` (a :class:`FrozenW`) for a solve on v and W from h,
    once a solve: ``numer = w.T v`` by the same k-chain as the first
    accumulator of :func:`snmf_mu_pass1`'s H update, and ``lam =
    max(w h, flr)`` as its first product.  Operands as for
    :func:`snmf_mu_pass1`.  Counts as no launch of ``LAUNCHES``, which
    count iterations."""
    m, r, n = _check_operands(v, h, w)
    if v.device.type == "cpu":
        return snmf_mu_frozen_init_reference(v, h, w, frozen)

    frozen.numer = torch.zeros_like(h)
    frozen.lam = torch.full((m, -(-n // 4) * 4), FLR, dtype=torch.float32,
                            device=v.device)
    frozen.w_pad, frozen.wt_pad = pad_rows(w), pad_rows(w.T)
    frozen.made_from(v, h, w)
    if min(m, r, n) == 0:
        return
    lib = _library()
    v_pad = pad_rows(v)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.snmf_mu_frozen_init(
            v_pad.data_ptr(), h.data_ptr(), frozen.w_pad.data_ptr(),
            frozen.wt_pad.data_ptr(), frozen.numer.data_ptr(),
            frozen.lam.data_ptr(), m, r, n, stream)
    _raise_on(err, lib, "snmf_mu_frozen_init", m, r, n)


def snmf_mu_frozen_pass1(h, sparsity, frozen):
    """Kernel B4 on the frozen route: the H update alone,
    ``h_new = h * frozen.numer / max(w.T frozen.lam + sparsity, flr)``, and
    ``sp_sum = sparsity * sum(h_new)`` (a 0-dim tensor): the first and last
    outputs of :func:`snmf_mu_pass1` on the state's v and W, bit for bit.
    ``frozen`` must hold ``h`` (:func:`snmf_mu_frozen_init`, or the last
    :func:`snmf_mu_frozen_pass2`); else ValueError.  Returns
    ``(h_new, sp_sum)``."""
    if isinstance(sparsity, bool) or not isinstance(sparsity, (int, float)):
        raise TypeError("sparsity must be a Python number (B4 takes a "
                        "scalar sparsity)")
    if h.device.type == "cpu":
        return snmf_mu_frozen_pass1_reference(h, float(sparsity), frozen)

    frozen.require(h)
    (m, n), r = frozen.v.shape, h.shape[0]
    h_new = torch.empty_like(h)
    sp_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    if min(m, r, n) == 0:
        return h_new.zero_(), sp_sum
    lib = _library()
    ws = torch.empty(lib.snmf_mu_frozen_pass1_workspace(m, r, n),
                     dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.snmf_mu_frozen_pass1(
            h.data_ptr(), frozen.wt_pad.data_ptr(), frozen.numer.data_ptr(),
            frozen.lam.data_ptr(), float(sparsity), h_new.data_ptr(),
            sp_sum.data_ptr(), ws.data_ptr(), m, r, n, stream)
    _raise_on(err, lib, "snmf_mu_frozen_pass1", m, r, n)
    LAUNCHES["pass1"] += 1
    return h_new, sp_sum


def snmf_mu_frozen_pass2(v, h, frozen):
    """Kernel B5 on the frozen route: the divergence of
    :func:`snmf_mu_pass2` on v, h and the state's W, bit for bit, and
    ``frozen.lam = max(w h, flr)`` from the same product: the state then
    holds ``h``, for the next :func:`snmf_mu_frozen_pass1`.  v (m, n) and
    h (r, n) of the shapes :func:`snmf_mu_frozen_init` filled it for."""
    if v.device.type == "cpu":
        return snmf_mu_frozen_pass2_reference(v, h, frozen)

    if frozen.w is None:
        raise ValueError("the frozen state is empty: snmf_mu_frozen_init "
                         "first")
    m, r, n = _check_operands(v, h, frozen.w)
    if frozen.numer.shape != (r, n):
        raise ValueError(f"the frozen state is for h of shape "
                         f"{tuple(frozen.numer.shape)}, not {(r, n)}")
    div = torch.zeros((), dtype=torch.float32, device=v.device)
    if m == 0 or n == 0:
        frozen.moved_to(h)
        return div
    lib = _library()
    ws = torch.empty(lib.snmf_mu_pass2_workspace(m, r, n),
                     dtype=torch.float32, device=v.device)
    v_pad = pad_rows(v)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.snmf_mu_frozen_pass2(
            v_pad.data_ptr(), h.data_ptr(), frozen.w_pad.data_ptr(),
            frozen.lam.data_ptr(), div.data_ptr(), ws.data_ptr(), m, r, n,
            stream)
    _raise_on(err, lib, "snmf_mu_frozen_pass2", m, r, n)
    frozen.moved_to(h)
    LAUNCHES["pass2"] += 1
    return div


class Passes(NamedTuple):
    """The passes of both routes: the kernels, or their plain versions."""

    pass1: Callable
    pass2: Callable
    frozen_init: Callable
    frozen_pass1: Callable
    frozen_pass2: Callable


KERNEL_PASSES = Passes(snmf_mu_pass1, snmf_mu_pass2, snmf_mu_frozen_init,
                       snmf_mu_frozen_pass1, snmf_mu_frozen_pass2)
PLAIN_PASSES = Passes(snmf_mu_pass1_reference, snmf_mu_pass2_reference,
                      snmf_mu_frozen_init_reference,
                      snmf_mu_frozen_pass1_reference,
                      snmf_mu_frozen_pass2_reference)


def mu_ed_iteration(v, h, w, sparsity, w_mask, passes=None, update_w=None,
                    reduce_sum=None, frozen=None):
    """One MU iteration: B4, the normalization-aware W update with column
    renorm (sparse_nmf_gpu.m:232-264; plain PyTorch on (m, r) tensors),
    then B5 on the new W.  ``w_mask`` (r,) bool: the columns that update.
    ``passes``: :class:`Passes` in place of the kernels (the plain
    versions, :data:`PLAIN_PASSES`, for a parity run).  ``update_w``:
    ``bool(w_mask.any())`` where the caller already knows it (it costs a
    host read).  When it is False W comes back as it went in, with no
    update and no renorm, as in the JAX package's default route, and the
    iteration takes the frozen route: B4 as the H update alone and B5
    keeping lam in ``frozen``, a :class:`FrozenW` that a solve's
    iterations share so that W^T v is computed once; it is filled again
    wherever it does not hold this v, h and W (a new one when None).
    ``reduce_sum(*t)``: where the
    frames are split over ranks, the sum over them of B4's W statistics and
    ``sum(sp h')`` (between B4 and the W update) and of B5's divergence
    (after B5); on the frozen route of the divergence and ``sum(sp h')``
    together, after B5.
    Returns ``(h_new, w_new, div, cost)``; div and cost are 0-dim tensors."""
    passes = passes or KERNEL_PASSES
    if update_w is None:
        update_w = bool(w_mask.any())
    if not update_w:
        frozen = FrozenW() if frozen is None else frozen
        if not frozen.holds(v, h, w):
            passes.frozen_init(v, h, w, frozen)
        h_new, sp_sum = passes.frozen_pass1(h, sparsity, frozen)
        div = passes.frozen_pass2(v, h_new, frozen)
        if reduce_sum is not None:
            div, sp_sum = reduce_sum(div, sp_sum)
        return h_new, w, div, div + sp_sum
    h_new, a, b, sp_sum = passes.pass1(v, h, w, sparsity)
    if reduce_sum is not None:
        a, b, sp_sum = reduce_sum(a, b, sp_sum)
    dpw = b + (a * w).sum(dim=0, keepdim=True) * w
    dmw = a + (b * w).sum(dim=0, keepdim=True) * w
    w_new = w * dmw / dpw.clamp_min(FLR)
    w_new = torch.where(w_mask[None, :], w_new, w)
    # like the TPU solver, renormalises every column, frozen ones too
    w_new = w_new / (w_new * w_new).sum(dim=0, keepdim=True).sqrt()
    div = passes.pass2(v, h_new, w_new)
    if reduce_sum is not None:
        (div,) = reduce_sum(div)
    return h_new, w_new, div, div + sp_sum


def sparse_nmf_ed(v, w0, h0, sparsity, w_mask, max_iter, conv_eps,
                  passes=None, reduce_sum=None):
    """Full ED sparse NMF with the MU passes (``sparse_nmf_ed_pallas``).

    v (m, n), w0 (m, r), h0 (r, n) float32 tensors on one device;
    ``sparsity`` a Python number; ``w_mask`` (r,) bool tensor.  Normalises
    W's columns and rescales H to match, then iterates until ``max_iter``
    or, when ``conv_eps > 0``, until the cost moves by less than
    ``conv_eps`` relative to the last (one host read per iteration, only
    then).  With no column of W to update, W stays exactly the normalised
    ``w0``, and the iterations take the frozen route; traced, the counter
    ``snmf.mu_iters_frozen_w`` adds their number once a solve.  Iterates
    on the frames padded with zero frames to a multiple of four.
    ``passes`` and ``reduce_sum``: see :func:`mu_ed_iteration`.
    Returns ``(w, h, divs, costs, n_iter)``; divs and costs hold the
    ``n_iter`` iterations run."""
    wn = (w0 * w0).sum(dim=0).sqrt()
    w = (w0 / wn[None, :]).contiguous()
    n = v.shape[1]
    # whole groups of four frames: rows of v and h then start on 16 bytes and
    # the kernels take their wide copies.  A zero frame keeps a zero
    # activation, adds nothing to either statistic nor to sum(h), and
    # m * flr^2 = 1e-18 m to the divergence: below f32's resolution there.
    h, v = pad_rows(h0 * wn[:, None]), pad_rows(v)
    update_w = bool(w_mask.any())
    frozen = None if update_w else FrozenW()
    divs, costs = [], []
    for it in range(max_iter):
        h, w, div, cost = mu_ed_iteration(v, h, w, sparsity, w_mask, passes,
                                          update_w, reduce_sum, frozen)
        divs.append(div)
        costs.append(cost)
        if converged(costs, conv_eps):
            break
    if not update_w:
        count("snmf.mu_iters_frozen_w", len(costs))
    return (w, h[:, :n].contiguous(), history(divs, v), history(costs, v),
            len(costs))


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
