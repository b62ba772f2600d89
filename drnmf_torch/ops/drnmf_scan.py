"""Kernels B1, B2 and B3: the DR-NMF recurrence on an H100.

- B1, ``drnmf_scan_factored``: the folded-U + factored-S recurrence.
  Replaces ``drnmf_tpu/ops/pallas/drnmf_scan.py::_kernel_factored`` (entry
  ``drnmf_scan_pallas_factored``).  CUDA C++ in
  ``csrc/drnmf_scan_factored.cu``.
- B2, ``drnmf_scan_factored(..., interleave=True)``: the same function
  with the batch's two halves carried as two independent chains of
  tensor-core products.  Replaces ``_kernel_factored_interleaved``.  CUDA
  C++ in ``csrc/drnmf_scan_factored_interleaved.cu``.
- B3, ``drnmf_scan_dense``: the recurrence with dense (2r, 2r) U and S
  matrices, for a model whose U trains or whose checkpoint breaks the
  fold's structure.  Replaces ``_kernel`` (entry ``drnmf_scan_pallas``).
  CUDA C++ in ``csrc/drnmf_scan_dense.cu``.
- ``drnmf_scan_factored_backward``: the reverse delta chain of B1's
  function, the training backward.  The port's own kernel: the JAX package
  runs it as an XLA scan (``drnmf_tpu/models/batched_grad.py::_bwd``,
  ``back_step``).  CUDA C++ in ``csrc/drnmf_scan_factored_bwd.cu``: each
  block owns fixed stripes of 2r.  The training forward is B1 with
  ``keep_layers=True``, which also returns every layer's hidden state.

All are built for ``sm_90a`` at first use (see ``build.py``).

What bounds them on the card.  B1/B2: per batch row and step
2·F·2r·(2K−1) flops against a weight stack (18.5 MB at the flagship) that
fits the L2, so the f32 rate of the CUDA cores (B1) or of the tensor
cores (B2) at a large batch, and the chain of dependent steps at a few
rows.  All three run the whole scan in one cooperative launch, each
phase spread over persistent blocks with a grid synchronisation between
phases.  B1: each half-layer one tiled f32
product whose output tiles go to the blocks, so each weight is read once
per row tile and step; its back-projection ``hid @ dkT`` is split over
fixed stretches of the 2r axis, summed in a phase of their own in a fixed
order, so a few rows still fill the card (``factored_scan_plan``).  B2
runs B1's phases with every product on the tensor cores, as B3 does
(below): the weights are the A operand, 2r or F on the instruction's M
axis, the batch on its N axis; the first ceil(B/2) rows and the rest are
two chains whose products a work item issues in turn, waiting only for
the older group, so one chain's products run while the other's issue
(``interleaved_scan_plan``).  B3: 2·(2r)²·(2K−1) +
2·F·2r·K flops per row and step against a weight stack (106 MB at the
flagship) that fits no cache, so operations at a large batch and the
weight reads from HBM and the grid syncs at a few rows.  Each layer runs
on the tensor cores in error-compensated TF32 (three products a term, as
B4/B5), transposed so that 2r rides the instruction's M axis and the
batch its N axis (8 to 64 wide), its contraction ([h | hid | x_t] as one
axis) cut into fixed stretches whose partials a second phase adds in
stretch order (``dense_scan_plan``).  The backward: 2(K−1) of B1's thin
products per row and step, the layer stack read and the deltas written
once (1.3 GB at B=32, T=500), so the bytes at the training batch, and
like B1 the chain of dependent phases at a few rows; each block owns
fixed stripes of W columns of 2r for the whole scan, and the phases that
need no other block's data are fused, 1 + 2(K−1) grid syncs a step
(``backward_plan``).  The source notes in the ``.cu`` files give the
trade-offs.

B1, B2, B3 and the backward sum every output in a fixed order and use no
atomics: a repeat is bit-equal, and the order of a row's sums does not
depend on the batch it runs in.  B2 sums in another order than B1 (and on the tensor
cores), so the two agree within rounding.

Each wrapper launches its kernel for CUDA tensors or raises; for CPU
tensors it runs the plain version beside it
(``drnmf_scan_factored_reference``, ``drnmf_scan_dense_reference``,
``drnmf_scan_factored_backward_reference``), which is the same function in
eager PyTorch and the reference the kernel is held against.
"""

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from ..device import free_bytes
from ..utils.profiling import count, span
from . import build

SOURCE = "drnmf_scan_factored.cu"  # B1
INTERLEAVED_SOURCE = "drnmf_scan_factored_interleaved.cu"  # B2
DENSE_SOURCE = "drnmf_scan_dense.cu"  # B3
BACKWARD_SOURCE = "drnmf_scan_factored_bwd.cu"  # B1's backward
# kernel launches since the last reset, by kernel, and ``time_loop``: the
# scans that ran the model's plain PyTorch time loop instead (the route of
# ``models.drnmf.make_scan``); chip_smoke.py reads them to show which route
# each path went through
LAUNCHES = {"factored": 0, "interleaved": 0, "dense": 0,
            "factored_backward": 0, "time_loop": 0}
# tile sides B1 is built for (rows, and columns of each product)
DENSE_TILES = (16, 32, 64)
# B1: rows of the back-projection's contraction one split sums (a multiple
# of the kernel's contraction chunk, 32), and columns of one partial rowsum
FACTORED_SPLIT = 256
FACTORED_GROUP = 16
# B3: rows of 2r a work item covers (the instruction's M axis, two
# warpgroups), the batch tiles it is built for (the instruction's N), and
# the stretches a later layer's contraction is cut into (2r = 2000 gives 16
# row tiles, so 128 items a batch tile: one for each SM of an H100)
DENSE_M_TILE = 128
DENSE_BATCH_TILES = (8, 16, 32, 64)
DENSE_STRETCHES = 8
# B2: rows of 2r or F a work item covers (the instruction's M axis, one
# warpgroup), the batch tiles of each chain it is built for (N), and the
# fixed stretches of its back-projection's contraction (2r = 2000 gives
# L = 128)
INTERLEAVED_M_TILE = 64
INTERLEAVED_BATCH_TILES = (8, 16)
INTERLEAVED_BP_STRETCHES = 16
# the backward: columns of 2r a stripe holds (W, as the kernel's
# constant), the most sub-stretches a projection's contraction over F is cut
# into, and the least stripes one chunk of a sum over stripes adds (more
# where 2r is wider than BACKWARD_MAX_CHUNKS chunks of them)
BACKWARD_STRIPE = 16
BACKWARD_SUBS = 16
BACKWARD_CHUNK = 16
BACKWARD_MAX_CHUNKS = 32
# the backward's launches by instance since the last reset (each also
# counts in LAUNCHES["factored_backward"]): weights streamed from L2 with
# each phase's operands, or resident in shared memory for the whole scan
BACKWARD_INSTANCES = {"streamed": 0, "resident": 0}
# within ``streamed_backward()``: the plan refuses the resident instance
_RESIDENT_REFUSED = False


def _error_strings(lib):
    lib.drnmf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.drnmf_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library():
    lib = build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.drnmf_scan_factored.argtypes = [ptr] * 16 + [i32] * 13 + [ptr]
    lib.drnmf_scan_factored.restype = i32
    lib.drnmf_scan_factored_capacity.argtypes = [i32]
    lib.drnmf_scan_factored_capacity.restype = i32
    lib.drnmf_scan_factored_keep_capacity.argtypes = [i32]
    lib.drnmf_scan_factored_keep_capacity.restype = i32
    lib.drnmf_grid_sync_probe.argtypes = [i32, i32, ptr]
    lib.drnmf_grid_sync_probe.restype = i32
    return _error_strings(lib)


@functools.cache
def _interleaved_library():
    lib = build.load(INTERLEAVED_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.drnmf_scan_factored_interleaved.argtypes = ([ptr] * 15 + [i32] * 14
                                                    + [ptr])
    lib.drnmf_scan_factored_interleaved.restype = i32
    lib.drnmf_scan_factored_interleaved_capacity.argtypes = [i32]
    lib.drnmf_scan_factored_interleaved_capacity.restype = i32
    return _error_strings(lib)


@functools.cache
def _backward_library():
    lib = build.load(BACKWARD_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.drnmf_scan_factored_backward.argtypes = [ptr] * 15 + [i32] * 16 + [ptr]
    lib.drnmf_scan_factored_backward.restype = i32
    lib.drnmf_scan_factored_backward_capacity.argtypes = [i32] * 3
    lib.drnmf_scan_factored_backward_capacity.restype = i32
    lib.drnmf_scan_factored_backward_smem.argtypes = [i32] * 6
    lib.drnmf_scan_factored_backward_smem.restype = i32
    lib.drnmf_scan_factored_backward_max_smem.argtypes = []
    lib.drnmf_scan_factored_backward_max_smem.restype = i32
    return _error_strings(lib)


@functools.cache
def _dense_library():
    lib = build.load(DENSE_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.drnmf_scan_dense.argtypes = [ptr] * 10 + [i32] * 11 + [ptr]
    lib.drnmf_scan_dense.restype = i32
    lib.drnmf_scan_dense_capacity.argtypes = [i32]
    lib.drnmf_scan_dense_capacity.restype = i32
    return _error_strings(lib)


def drnmf_scan_factored_reference(x, step_mask, h0, diag1, off1, c_uk,
                                  dkt_stack, dka_stack, b_stack,
                                  keep_layers: bool = False):
    """Plain PyTorch version of the kernel, in the arithmetic order of
    ``models.drnmf.u_terms``/``layer_pre``.  Arguments as for
    :func:`drnmf_scan_factored`; with ``keep_layers`` the layer stack has
    Bp = B."""
    bsz, k_layers, n2r = x.shape[0], dka_stack.shape[0], h0.shape[-1]
    h = h0
    outs, layers = [], []
    for t in range(x.shape[1]):
        x_t = x[:, t]
        rs = h.sum(dim=1, keepdim=True)
        hidden = torch.relu(h * (diag1 - off1) + off1 * rs
                            + x_t @ dka_stack[0] + b_stack[0])
        step = [hidden]
        for k in range(1, k_layers):
            resid = x_t - hidden @ dkt_stack[k - 1]
            hidden = torch.relu(c_uk * rs + hidden + resid @ dka_stack[k]
                                + b_stack[k])
            step.append(hidden)
        if keep_layers:
            layers.append(torch.stack(step))
        h = torch.where(step_mask[:, t, None], hidden, h)
        outs.append(h)
    out = (torch.stack(outs, dim=1) if outs
           else x.new_empty((bsz, 0, n2r)))
    if not keep_layers:
        return out
    h_all = (torch.stack(layers).permute(1, 3, 0, 2).contiguous() if layers
             else x.new_empty((k_layers, n2r, 0, bsz)))
    return out, h_all


def drnmf_scan_factored_backward_reference(g, step_mask, h_all, diag1, off1,
                                           c_uk, dkt_stack, dka_stack):
    """Plain PyTorch version of the backward kernel: ``back_step`` of
    ``drnmf_tpu/models/batched_grad.py`` (:99-121) in its arithmetic order,
    step by step from the last.  Arguments and results as for
    :func:`drnmf_scan_factored_backward`."""
    bsz, t_len, n2r = g.shape
    k_layers, bp = h_all.shape[0], h_all.shape[3]
    f = dka_stack.shape[1]
    delta = g.new_zeros((k_layers, n2r, t_len, bp))
    p_all = g.new_zeros((k_layers - 1, f, t_len, bp))
    gamma = g.new_zeros((bsz, n2r))
    m = step_mask.to(g.dtype)
    for t in reversed(range(t_len)):
        h_t = h_all[:, :, t, :bsz].transpose(1, 2)  # (K, B, 2r)
        m_t = m[:, t, None]
        go = g[:, t] + gamma
        g_h = go * m_t
        gamma_new = go * (1.0 - m_t)
        for k in range(k_layers - 1, 0, -1):
            d_k = g_h * (h_t[k] > 0)
            delta[k, :, t, :bsz] = d_k.T
            p = d_k @ dka_stack[k].T
            p_all[k - 1, :, t, :bsz] = p.T
            g_h = d_k - p @ dkt_stack[k - 1].T
            gamma_new = gamma_new + c_uk * d_k.sum(dim=1, keepdim=True)
        d_0 = g_h * (h_t[0] > 0)
        delta[0, :, t, :bsz] = d_0.T
        gamma = (gamma_new + d_0 * (diag1 - off1)
                 + off1 * d_0.sum(dim=1, keepdim=True))
    return delta, p_all, gamma


def row_tile(bsz: int) -> int:
    """Rows of an output tile of B1: the smallest built side that covers
    the batch (64 at most)."""
    return next((s for s in DENSE_TILES if s >= bsz), DENSE_TILES[-1])


class FactoredPlan(NamedTuple):
    """How B1 cuts its phases (``factored_scan_plan``)."""
    tm: int  # rows of every tile
    tn: int  # columns of a projection's output tile (of 2r)
    tf: int  # columns of a back-projection's output tile (of F)
    split: int  # L: contraction rows (of 2r) one back-projection split sums
    splits: int  # S = ceil(2r / L)
    groups: int  # G: partial rowsums a row, FACTORED_GROUP columns each
    bp: int  # the batch padded to the row tile
    grid: int  # blocks of the cooperative launch


def factored_scan_plan(bsz: int, f: int, n2r: int, n_sm: int,
                       capacity: int) -> FactoredPlan:
    """B1's tiles for this batch and width on a card with ``n_sm`` SMs that
    keeps ``capacity`` blocks of the kernel resident.

    L, S and G depend on (F, 2r) alone, so a row's bits do not depend on
    the batch or the grid.  The tiles only keep the SMs busy: each
    projection's output tile TM x TN and each back-projection item (row
    tile, TF columns of F, one split) goes to one block; a phase takes
    about (its items per SM, rounded up) x (width + 16), the 16 standing
    for the rows of activations every tile loads, whatever its width.  The
    widest side wins a tie.  The grid is the largest phase's item count,
    at most ``capacity``."""
    tm = row_tile(bsz)
    bp = -(-bsz // tm) * tm
    row_tiles = bp // tm
    splits = -(-n2r // FACTORED_SPLIT)

    def items(width, cols, per_tile=1):
        return row_tiles * -(-cols // width) * per_tile

    def pick(cols, per_tile=1):
        return min(reversed(DENSE_TILES), key=lambda w: -(
            -items(w, cols, per_tile) // n_sm) * (w + 16))

    tn, tf = pick(n2r), pick(f, splits)
    grid = min(max(items(tn, n2r), items(tf, f, splits)), capacity)
    return FactoredPlan(tm, tn, tf, FACTORED_SPLIT, splits,
                        -(-n2r // FACTORED_GROUP), bp, grid)


class InterleavedPlan(NamedTuple):
    """How B2 cuts its phases (``interleaved_scan_plan``)."""
    mt: int  # rows of the weights' output axis an item covers (M)
    ni: int  # columns of each chain an item covers (N)
    half: int  # chain A's rows, ceil(B / 2); chain B has the rest
    bpc: int  # each chain's rows padded to ni: the scratch has 2·bpc
    fp: int  # F padded to a multiple of 4
    ld: int  # 2r padded to a multiple of 4
    split: int  # L: rows of 2r one back-projection stretch sums
    splits: int  # S = ceil(2r / L)
    groups: int  # G: partial rowsums a row, FACTORED_GROUP columns each
    p_items: int  # work items of a projection
    bp_items: int  # work items of a back-projection
    grid: int  # blocks of the cooperative launch


def interleaved_batch_tile(bsz: int, n2r: int, n_sm: int) -> int:
    """B2's batch tile (columns of each chain) for this batch: of the built
    tiles no wider than what covers a chain, the wider one whose
    projection has as many items as the card has SMs, or as many as the
    narrower gives where neither reaches that.  At 64 rows this gives 8:
    128 items, where 16 would give 64."""
    half = -(-bsz // 2)
    widest = next((w for w in INTERLEAVED_BATCH_TILES if w >= half),
                  INTERLEAVED_BATCH_TILES[-1])
    tiles = [ni for ni in reversed(INTERLEAVED_BATCH_TILES) if ni <= widest]

    def items(ni):
        return -(-n2r // INTERLEAVED_M_TILE) * -(-half // ni)

    target = min(n_sm, max(items(ni) for ni in tiles))
    return next(ni for ni in tiles if items(ni) >= target)


def interleaved_scan_plan(bsz: int, f: int, n2r: int, n_sm: int,
                          capacity: int) -> InterleavedPlan:
    """B2's cut for this batch and width on a card with ``n_sm`` SMs that
    keeps ``capacity`` blocks of the batch tile's kernel resident.

    Chain A takes rows [0, ceil(B/2)), chain B the rest; both are padded
    to the same multiple of the batch tile, and an item covers the same
    columns of each.  L (the smallest multiple of the kernel's 16-deep
    stage that cuts 2r into INTERLEAVED_BP_STRETCHES), S and G depend on
    (F, 2r) alone, so the order of a row's sums does not depend on the
    batch or the grid; the batch tile (``interleaved_batch_tile``) only
    keeps the SMs busy.  The grid is the larger phase's item count, at
    most ``capacity``."""
    mt, ni = INTERLEAVED_M_TILE, interleaved_batch_tile(bsz, n2r, n_sm)
    half = -(-bsz // 2)
    bpc = -(-half // ni) * ni
    fp, ld = -(-f // 4) * 4, -(-n2r // 4) * 4
    split = -(-n2r // (16 * INTERLEAVED_BP_STRETCHES)) * 16
    splits = -(-n2r // split)
    p_items = -(-n2r // mt) * (bpc // ni)
    bp_items = splits * -(-fp // mt) * (bpc // ni)
    return InterleavedPlan(mt, ni, half, bpc, fp, ld, split, splits,
                           -(-n2r // FACTORED_GROUP), p_items, bp_items,
                           min(max(p_items, bp_items), capacity))


def _launch_interleaved(x, step_mask, h0, diag1, off1, c_uk, dkt_stack,
                        dka_stack, b_stack, out, shapes):
    """Kernel B2 on the card: its scratch (rows of chain A, then of chain
    B, each padded to ``bpc``), zero-filled; raises on any refusal."""
    bsz, t_len, f = x.shape
    n2r, k_layers = h0.shape[-1], dka_stack.shape[0]
    dev = x.device
    lib = _interleaved_library()
    with torch.cuda.device(dev):
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        capacity = lib.drnmf_scan_factored_interleaved_capacity(
            interleaved_batch_tile(bsz, n2r, n_sm))
        if capacity < 1:
            why = ("the device has no cooperative launch, which orders the "
                   "phases across blocks" if capacity == 0 else
                   lib.drnmf_cuda_error_string(-capacity).decode())
            raise RuntimeError(f"drnmf_scan_factored (interleaved) cannot "
                               f"run here: {why} {shapes}")
        plan = interleaved_scan_plan(bsz, f, n2r, n_sm, capacity)
        half, bpc, fp, ld = plan.half, plan.bpc, plan.fp, plan.ld
        rows = 2 * bpc

        def by_chain(a, scratch):  # rows [0, half) then [half, B)
            scratch[..., :half, :a.shape[-1]] = a[..., :half, :]
            scratch[..., bpc:bpc + bsz - half, :a.shape[-1]] = a[..., half:, :]
            return scratch

        x_s = by_chain(x.transpose(0, 1), x.new_zeros((t_len, rows, fp)))
        carry = x.new_zeros((2, rows, ld))
        by_chain(h0, carry[0])
        hid = x.new_zeros((2, rows, ld))
        part = x.new_zeros((plan.splits, rows, fp))
        resid = x.new_zeros((rows, fp))
        rsp = x.new_zeros((2, plan.groups, rows))
        rs = x.new_zeros((rows,))
        # rows of whole 16-byte copies, zero-padded
        dka = (dka_stack if ld == n2r else
               torch.nn.functional.pad(dka_stack, (0, ld - n2r)))
        dkt = (dkt_stack if fp == f else
               torch.nn.functional.pad(dkt_stack, (0, fp - f)))
        err = lib.drnmf_scan_factored_interleaved(
            x_s.data_ptr(), step_mask.data_ptr(), diag1.data_ptr(),
            off1.data_ptr(), c_uk.data_ptr(), dkt.data_ptr(), dka.data_ptr(),
            b_stack.data_ptr(), carry.data_ptr(), hid.data_ptr(),
            part.data_ptr(), resid.data_ptr(), rsp.data_ptr(), rs.data_ptr(),
            out.data_ptr(), bsz, half, bpc, t_len, f, fp, n2r, ld, k_layers,
            plan.ni, plan.split, plan.splits, plan.groups, plan.grid,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.drnmf_cuda_error_string(err).decode()
        raise RuntimeError(f"drnmf_scan_factored (interleaved) launch "
                           f"failed: {msg} {shapes}, {plan}")
    LAUNCHES["interleaved"] += 1
    return out


def drnmf_scan_factored(x, step_mask, h0, diag1, off1, c_uk, dkt_stack,
                        dka_stack, b_stack, interleave: bool = False,
                        keep_layers: bool = False):
    """Folded + factored recurrence over the whole sequence.

    x (B, T, F) f32; step_mask (B, T) bool (True = valid step); h0 (B, 2r);
    diag1 (2r,); off1, c_uk 0-dim or 1-element f32 tensors;
    dkt_stack (K-1, 2r, F) = Dhat_k^T (a dummy (1, 2r, F) when K == 1);
    dka_stack (K, F, 2r) = Dhat_k/alph_k; b_stack (K, 2r).
    Returns the hidden states (B, T, 2r) f32; masked steps hold the carry.
    ``interleave``: on the card, launch kernel B2 (the batch's halves as
    two chains of tensor-core products) instead of B1; the function
    computed is the same, for any B, summed in another order.
    ``keep_layers`` (B1 only; the training forward): also return every
    layer's hidden state of every step before a masked step holds the
    carry, (K, 2r, T, Bp) with the batch innermost, Bp the batch padded to
    B1's row tile on the card (B on the CPU; padded columns hold what the
    kernel computed for zero rows): the layout the backward reads.

    On the card B1 and B2 need a device with cooperative launch; the
    wrapper raises otherwise, and with the shapes and the plan on any
    launch error.  It allocates the kernel's scratch.  B1
    (``factored_scan_plan`` says how it is cut): x with the batch
    innermost and padded to the row tile (T, F, Bp), the carry and hidden
    planes (2, 2r, Bp) each, the split partials (S, F, Bp), the residual
    (F, Bp) and the partial rowsums (2, G, Bp).  B2
    (``interleaved_scan_plan``): the rows of chain A, then of chain B,
    each padded to bpc (R = 2·bpc rows), batch-major with rows of whole
    16-byte copies: x (T, R, Fp), the carry and hidden planes (2, R, ld)
    each, the back-projection partials (S, R, Fp), the residual (R, Fp),
    the partial rowsums (2, G, R) and the rowsums (R); dkT padded to rows of Fp and
    dka to rows of ld where F or 2r is not a multiple of 4.
    """
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
        build.check_operand(name, t, shape, dtype, dev)

    if interleave and keep_layers:
        raise ValueError("keep_layers is a flag of B1, not of B2")
    if dev.type == "cpu":
        return drnmf_scan_factored_reference(
            x, step_mask, h0, diag1, off1, c_uk, dkt_stack, dka_stack,
            b_stack, keep_layers=keep_layers)
    if dev.type != "cuda":
        raise ValueError(f"drnmf_scan_factored runs on cuda or cpu, not {dev}")

    out = torch.empty((bsz, t_len, n2r), dtype=f32, device=dev)
    if bsz == 0 or t_len == 0:
        if keep_layers:
            return out, out.new_empty((k_layers, n2r, t_len,
                                       -(-bsz // row_tile(bsz)) * row_tile(bsz)))
        return out
    shapes = f"(B={bsz}, T={t_len}, F={f}, 2r={n2r}, K={k_layers})"
    if interleave:
        return _launch_interleaved(x, step_mask, h0, diag1, off1, c_uk,
                                   dkt_stack, dka_stack, b_stack, out, shapes)

    lib = _library()
    with torch.cuda.device(dev):
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        capacity = (lib.drnmf_scan_factored_keep_capacity if keep_layers
                    else lib.drnmf_scan_factored_capacity)(row_tile(bsz))
        if capacity < 1:
            why = ("the device has no cooperative launch, which orders the "
                   "phases across blocks" if capacity == 0 else
                   lib.drnmf_cuda_error_string(-capacity).decode())
            raise RuntimeError(f"drnmf_scan_factored cannot run here: {why} "
                               f"{shapes}")
        plan = factored_scan_plan(bsz, f, n2r, n_sm, capacity)
        bp = plan.bp
        # scratch: x batch-innermost, the carry (zero past the batch), the
        # hidden state, the split partials, the residual, the rowsums
        x_t = x.new_zeros((t_len, f, bp))
        x_t[:, :, :bsz] = x.permute(1, 2, 0)
        carry = x.new_zeros((2, n2r, bp))
        carry[0, :, :bsz] = h0.T
        hid = x.new_empty((2, n2r, bp))
        part = x.new_empty((plan.splits, f, bp))
        resid = x.new_empty((f, bp))
        rsp = x.new_empty((2, plan.groups, bp))
        rs = x.new_empty((bp,))
        # every element is written: each layer's epilogue covers (2r, Bp)
        h_all = (x.new_empty((k_layers, n2r, t_len, bp)) if keep_layers
                 else None)
        err = lib.drnmf_scan_factored(
            x_t.data_ptr(), step_mask.data_ptr(), diag1.data_ptr(),
            off1.data_ptr(), c_uk.data_ptr(), dkt_stack.data_ptr(),
            dka_stack.data_ptr(), b_stack.data_ptr(), carry.data_ptr(),
            hid.data_ptr(), part.data_ptr(), resid.data_ptr(),
            rsp.data_ptr(), rs.data_ptr(), out.data_ptr(),
            None if h_all is None else h_all.data_ptr(), bsz, bp, t_len,
            f, n2r, k_layers, plan.tm, plan.tn, plan.tf, plan.split,
            plan.splits, plan.groups, plan.grid,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.drnmf_cuda_error_string(err).decode()
        raise RuntimeError(f"drnmf_scan_factored launch failed: {msg} "
                           f"{shapes}, {plan}")
    LAUNCHES["factored"] += 1
    return out if h_all is None else (out, h_all)


def drnmf_scan_factored_backward(g, step_mask, h_all, diag1, off1, c_uk,
                                 dkt_stack, dka_stack):
    """The reverse delta chain of the folded + factored recurrence: the
    backward of ``drnmf_scan_factored``, ``back_step`` of
    ``drnmf_tpu/models/batched_grad.py`` over every step from the last.

    g (B, T, 2r) f32: the loss's gradient of the scan's output;
    step_mask (B, T) bool; h_all (K, 2r, T, Bp): every layer's hidden
    state, as ``drnmf_scan_factored(..., keep_layers=True)`` returns it;
    diag1, off1, c_uk, dkt_stack, dka_stack as for the forward.  Returns
    (delta (K, 2r, T, Bp): each layer's pre-activation gradient, zero in
    padded columns and masked steps; p (K-1, F, T, Bp): ``d_k @ dka_k^T``
    of each later layer; gamma (B, 2r): the gradient of h0).

    On the card the kernel needs a device with cooperative launch and room
    for its outputs and scratch (delta, p, g batch-innermost (T, 2r, Bp),
    the stripes' partials (S, F, Bp), rowsums (S, Bp) and row totals
    (2, S, Bp), two (2r, Bp) planes) in the card's free memory; the
    wrapper raises otherwise, and with the shapes and the plan on any
    launch error.  ``drnmf_scan_factored_backward_plan`` says how it is
    cut.  Once a call it cuts Dhat (K-1, F, 2r) and dka^T (K-1, 2r, Fp)
    into stripes of W columns of 2r, each stripe one contiguous block
    (zero past 2r and past F).
    """
    if g.dim() != 3:
        raise ValueError(f"g must be (B, T, 2r), got {tuple(g.shape)}")
    bsz, t_len, n2r = g.shape
    if h_all.dim() != 4:
        raise ValueError(f"h_all must be (K, 2r, T, Bp), got "
                         f"{tuple(h_all.shape)}")
    k_layers, bp = h_all.shape[0], h_all.shape[3]
    f = dka_stack.shape[1]
    dev = g.device
    f32 = torch.float32
    off1 = off1.reshape(1) if isinstance(off1, torch.Tensor) else off1
    c_uk = c_uk.reshape(1) if isinstance(c_uk, torch.Tensor) else c_uk
    for name, t, shape, dtype in [
            ("g", g, (bsz, t_len, n2r), f32),
            ("step_mask", step_mask, (bsz, t_len), torch.bool),
            ("h_all", h_all, (k_layers, n2r, t_len, bp), f32),
            ("diag1", diag1, (n2r,), f32),
            ("off1", off1, (1,), f32),
            ("c_uk", c_uk, (1,), f32),
            ("dkt_stack", dkt_stack, (max(1, k_layers - 1), n2r, f), f32),
            ("dka_stack", dka_stack, (k_layers, f, n2r), f32)]:
        build.check_operand(name, t, shape, dtype, dev)
    if bp < bsz:
        raise ValueError(f"h_all has {bp} columns a step, fewer than the "
                         f"batch ({bsz})")

    if dev.type == "cpu":
        return drnmf_scan_factored_backward_reference(
            g, step_mask, h_all, diag1, off1, c_uk, dkt_stack, dka_stack)
    if dev.type != "cuda":
        raise ValueError(f"drnmf_scan_factored_backward runs on cuda or cpu, "
                         f"not {dev}")

    gamma = g.new_zeros((bsz, n2r))
    if bsz == 0 or t_len == 0:
        return (g.new_zeros((k_layers, n2r, t_len, bp)),
                g.new_zeros((k_layers - 1, f, t_len, bp)), gamma)
    shapes = f"(B={bsz}, T={t_len}, F={f}, 2r={n2r}, K={k_layers})"
    b1_bp = -(-bsz // row_tile(bsz)) * row_tile(bsz)
    if bp != b1_bp:
        raise ValueError(f"h_all has {bp} columns a step, B1's row tile "
                         f"gives {b1_bp} {shapes}")
    lib = _backward_library()
    with torch.cuda.device(dev):
        plan = drnmf_scan_factored_backward_plan(bp, f, n2r, k_layers)
        if plan.capacity < 1:
            why = ("the device has no cooperative launch, which orders the "
                   "phases across blocks" if plan.capacity == 0 else
                   lib.drnmf_cuda_error_string(-plan.capacity).decode())
            raise RuntimeError(f"drnmf_scan_factored_backward cannot run "
                               f"here: {why} {shapes}")
        n_stripe = plan.stripes * plan.stripe
        n_w = max(1, k_layers - 1)
        need = (4 * ((k_layers * n2r + (k_layers - 1) * f + n2r) * t_len * bp
                     + (plan.stripes * f + 3 * plan.stripes + 2 * n2r) * bp
                     + 2 * n_w * n_stripe * plan.fp + n_stripe)
                + t_len * bp)
        free = free_bytes(dev)
        if need > free:
            raise RuntimeError(f"drnmf_scan_factored_backward needs {need} "
                               f"bytes for its outputs and scratch, the card "
                               f"has {free} free {shapes}: cut the batch or "
                               f"the sequence length")
        # outputs, every element written by the kernel; scratch: g and the
        # step mask batch-innermost and zero past the batch, diag1 and the
        # weights cut into stripes of W columns of 2r (zero past 2r and
        # past F), the partials, the stripes' rowsums and row totals
        delta = g.new_empty((k_layers, n2r, t_len, bp))
        p_all = g.new_empty((k_layers - 1, f, t_len, bp))
        g_t = g.new_zeros((t_len, n2r, bp))
        g_t[:, :, :bsz] = g.permute(1, 2, 0)
        if k_layers > 1:
            pad = torch.nn.functional.pad
            wdk = (pad(dkt_stack, (0, 0, 0, n_stripe - n2r))
                   .reshape(k_layers - 1, plan.stripes, plan.stripe, f)
                   .transpose(2, 3).contiguous())
            wdkat = (pad(dka_stack[1:], (0, n_stripe - n2r, 0, plan.fp - f))
                     .reshape(k_layers - 1, plan.fp, plan.stripes, plan.stripe)
                     .permute(0, 2, 3, 1).contiguous())
        else:  # never read
            wdk = wdkat = dkt_stack
        mask_t = step_mask.new_zeros((t_len, bp), dtype=torch.uint8)
        mask_t[:, :bsz] = step_mask.T
        diag1_s = torch.nn.functional.pad(diag1, (0, n_stripe - n2r))
        gb = g.new_empty((n2r, bp))
        part = g.new_empty((plan.stripes, f, bp))
        rsu = g.new_empty((plan.stripes, bp))
        rowtot = g.new_empty((2, plan.stripes, bp))
        gamma_t = g.new_empty((n2r, bp))
        err = lib.drnmf_scan_factored_backward(
            g_t.data_ptr(), mask_t.data_ptr(), h_all.data_ptr(),
            diag1_s.data_ptr(), off1.data_ptr(), c_uk.data_ptr(),
            wdkat.data_ptr(), wdk.data_ptr(), delta.data_ptr(),
            p_all.data_ptr() if k_layers > 1 else None, gb.data_ptr(),
            part.data_ptr(), rsu.data_ptr(), rowtot.data_ptr(),
            gamma_t.data_ptr(), bsz, bp, t_len, f, plan.fp, n2r, k_layers,
            plan.rt, int(plan.resident), plan.stripes, plan.sub, plan.subs, plan.chunk, plan.chunks, plan.smem,
            plan.grid,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.drnmf_cuda_error_string(err).decode()
        raise RuntimeError(f"drnmf_scan_factored_backward launch failed: "
                           f"{msg} {shapes}, {plan}")
    LAUNCHES["factored_backward"] += 1
    BACKWARD_INSTANCES["resident" if plan.resident else "streamed"] += 1
    gamma.copy_(gamma_t[:, :bsz].T)
    return delta, p_all, gamma


class BackwardPlan(NamedTuple):
    """How the backward kernel cuts its phases (``backward_plan``)."""
    rt: int  # rows of a row tile (16 or 32; a block's item loops over them)
    stripe: int  # W: columns of 2r a stripe holds
    stripes: int  # S = ceil(2r / W): the partials of a back-projection
    fp: int  # F padded to a multiple of 4: the rows of dka^T's stripes
    sub: int  # depths of F one sub-stretch of a projection sums
    subs: int  # sub-stretches, ceil(F / sub)
    chunk: int  # stripes one chunk of a sum over stripes adds
    chunks: int  # ceil(S / chunk), at most BACKWARD_MAX_CHUNKS
    resident: bool  # every later layer's weight stripes in shared memory
    smem: int  # dynamic shared-memory bytes a block takes
    capacity: int  # co-resident blocks of the instance (< 1: refused)
    grid: int  # blocks of the cooperative launch
    syncs_per_step: int  # grid syncs a step, 1 + 2(K-1)


def backward_plan(bp: int, f: int, n2r: int, k_layers: int, max_smem: int,
                  capacity, smem_bytes) -> BackwardPlan:
    """The backward kernel's cut for B1's padded batch ``bp`` on a card
    whose blocks may take ``max_smem`` bytes of dynamic shared memory;
    ``capacity(rt, resident, smem)`` gives the co-resident blocks of an
    instance and ``smem_bytes(rt, resident, f, stripes, k_layers, subs)``
    the shared memory a block of it takes (the kernel's
    ``drnmf_scan_factored_backward_smem``).

    W (``BACKWARD_STRIPE``), the sub-stretches of F (at most
    BACKWARD_SUBS of equal depth) and the chunks of stripes (at least
    BACKWARD_CHUNK stripes, at most BACKWARD_MAX_CHUNKS chunks) depend on
    (F, 2r) alone, so a row's bits do not depend on the batch, the grid
    or the instance.
    The row tile is 16 rows where B1 pads the batch to 16, else 32.  The
    resident instance runs where K > 1, its bytes fit and the card keeps
    a block for every stripe at once (block b owns stripe b); else the
    streamed one, whose grid is the stripes, at most its capacity."""
    rt = 32 if bp % 32 == 0 else 16
    stripe = BACKWARD_STRIPE
    stripes = -(-n2r // stripe)
    sub = -(-f // BACKWARD_SUBS)
    subs = -(-f // sub)
    chunk = max(BACKWARD_CHUNK, -(-stripes // BACKWARD_MAX_CHUNKS))
    chunks = -(-stripes // chunk)

    def smem(resident):
        return smem_bytes(rt, resident, f, stripes, k_layers, subs)

    resident = False
    if k_layers > 1 and smem(True) <= max_smem:
        cap = capacity(rt, True, smem(True))
        resident = cap >= stripes
    if not resident:
        cap = capacity(rt, False, smem(False))
    return BackwardPlan(rt, stripe, stripes, -(-f // 4) * 4, sub, subs,
                        chunk, chunks, resident, smem(resident), cap,
                        max(1, min(stripes, cap)), 1 + 2 * (k_layers - 1))


def drnmf_scan_factored_backward_plan(bp: int, f: int, n2r: int,
                                      k_layers: int) -> BackwardPlan:
    """``backward_plan`` on the current card: the plan a call of
    ``drnmf_scan_factored_backward`` with B1's padded batch ``bp`` uses
    (the streamed instance within ``streamed_backward()``).  Builds and
    loads the kernel."""
    lib = _backward_library()

    def capacity(rt, resident, smem):
        if resident and _RESIDENT_REFUSED:
            return 0
        return lib.drnmf_scan_factored_backward_capacity(rt, int(resident),
                                                         smem)

    return backward_plan(
        bp, f, n2r, k_layers, lib.drnmf_scan_factored_backward_max_smem(),
        capacity,
        lambda rt, res, *cut: lib.drnmf_scan_factored_backward_smem(
            rt, int(res), *cut))


@contextlib.contextmanager
def streamed_backward():
    """Within: the backward's plan refuses the resident instance, as on a
    card that keeps too few of its blocks at once, so the weights stream
    from L2.  For the card checks, which hold the streamed instance
    against the plain version and the resident one."""
    global _RESIDENT_REFUSED
    before, _RESIDENT_REFUSED = _RESIDENT_REFUSED, True
    try:
        yield
    finally:
        _RESIDENT_REFUSED = before


def drnmf_scan_dense_reference(x, step_mask, h0, u1, uk, s_stack, w_stack,
                               b_stack):
    """Plain PyTorch version of kernel B3, in the arithmetic order of the
    TPU kernel: ``h @ U_k``, then ``+ hid @ S_{k-1}``, then ``+ x_t @ W_k``,
    then ``+ b_k``.  Arguments as for :func:`drnmf_scan_dense`."""
    k_layers = w_stack.shape[0]
    h = h0
    outs = []
    for t in range(x.shape[1]):
        x_t = x[:, t]
        hidden = None
        for k in range(k_layers):
            pre = h @ (u1 if k == 0 else uk)
            if k > 0:
                pre = pre + hidden @ s_stack[k - 1]
            pre = pre + x_t @ w_stack[k]
            hidden = torch.relu(pre + b_stack[k])
        h = torch.where(step_mask[:, t, None], hidden, h)
        outs.append(h)
    if not outs:
        return x.new_empty((x.shape[0], 0, h0.shape[-1]))
    return torch.stack(outs, dim=1)


class DensePlan(NamedTuple):
    """How B3 cuts its phases (``dense_scan_plan``)."""
    m_tile: int  # rows of 2r a work item covers (the instruction's M)
    ni: int  # batch columns a work item covers (the instruction's N)
    bp: int  # the batch padded to ni
    fp: int  # F padded to a multiple of 4: the rows of x's scratch
    ld: int  # 2r padded to a multiple of 4: the rows of planes and weights
    split: int  # L: the depths of one stretch of a layer's contraction
    stretches: int  # of a later layer, ceil((2·ld + fp) / L); layer 0 fewer
    items: int  # work items of a later layer's products
    grid: int  # blocks of the cooperative launch


def dense_batch_tile(bsz: int) -> int:
    """B3's batch tile: the narrowest built width that covers the batch,
    the widest (64) past it."""
    return next((s for s in DENSE_BATCH_TILES if s >= bsz),
                DENSE_BATCH_TILES[-1])


def dense_scan_plan(bsz: int, f: int, n2r: int, capacity: int) -> DensePlan:
    """B3's cut for this batch and width on a card that keeps ``capacity``
    blocks of the batch tile's kernel resident.

    A layer's contraction is one axis, [h | hid | x_t], of ld + ld + fp
    depths (ld + fp at layer 0), cut into stretches of L depths: L is the
    smallest multiple of 16 that cuts a later layer into DENSE_STRETCHES,
    so it depends on (F, 2r) alone and the order of a row's sums does not
    depend on the batch or the grid.  The grid is the largest phase's item
    count (a later layer's products), at most ``capacity``."""
    ni = dense_batch_tile(bsz)
    bp = -(-bsz // ni) * ni
    fp, ld = -(-f // 4) * 4, -(-n2r // 4) * 4
    split = -(-(2 * ld + fp) // (16 * DENSE_STRETCHES)) * 16
    stretches = -(-(2 * ld + fp) // split)
    items = stretches * -(-n2r // DENSE_M_TILE) * (bp // ni)
    return DensePlan(DENSE_M_TILE, ni, bp, fp, ld, split, stretches, items,
                     min(items, capacity))


def drnmf_scan_dense(x, step_mask, h0, u1, uk, s_stack, w_stack, b_stack):
    """Dense-U recurrence over the whole sequence (kernel B3).

    x (B, T, F) f32; step_mask (B, T) bool (True = valid step); h0 (B, 2r);
    u1, uk (2r, 2r); s_stack (K-1, 2r, 2r) (a dummy (1, 2r, 2r) when K == 1,
    never read); w_stack (K, F, 2r); b_stack (K, 2r).  Per step
    ``hid_k = relu(h @ U_k + hid_{k-1} @ S_{k-1} + x_t @ W_k + b_k)`` with
    ``U_0 = u1`` and ``U_{k>0} = uk``.  Returns the hidden states
    (B, T, 2r) f32; masked steps hold the carry.

    On the card the kernel needs a device with cooperative launch and room
    for one resident block; the wrapper raises otherwise, and with the
    shapes and plan on any launch error.  It allocates the kernel's scratch
    (``dense_scan_plan`` says how it is cut): x batch-major with rows of Fp
    floats (T, Bp, Fp), the carry and hidden planes (4, Bp, ld), zero past
    the batch, and the stretch partials (stretches, Bp, ld); where 2r is
    not a multiple of 4 it also pads the weights' rows to ld floats.

    Traced (``utils.profiling``), each call adds B x T to the counter
    ``scan.dense_row_steps`` (on the card, one B3 launch), and the scratch
    staging before the launch is the span ``scan.dense_stage``.
    """
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, F), got {tuple(x.shape)}")
    bsz, t_len, f = x.shape
    n2r = h0.shape[-1]
    k_layers = w_stack.shape[0]
    if k_layers < 1:
        raise ValueError("w_stack must hold at least one layer")
    dev = x.device
    f32 = torch.float32
    for name, t, shape, dtype in [
            ("x", x, (bsz, t_len, f), f32),
            ("step_mask", step_mask, (bsz, t_len), torch.bool),
            ("h0", h0, (bsz, n2r), f32),
            ("u1", u1, (n2r, n2r), f32),
            ("uk", uk, (n2r, n2r), f32),
            ("s_stack", s_stack, (max(1, k_layers - 1), n2r, n2r), f32),
            ("w_stack", w_stack, (k_layers, f, n2r), f32),
            ("b_stack", b_stack, (k_layers, n2r), f32)]:
        build.check_operand(name, t, shape, dtype, dev)

    count("scan.dense_row_steps", bsz * t_len)
    if dev.type == "cpu":
        return drnmf_scan_dense_reference(x, step_mask, h0, u1, uk, s_stack,
                                          w_stack, b_stack)
    if dev.type != "cuda":
        raise ValueError(f"drnmf_scan_dense runs on cuda or cpu, not {dev}")

    out = torch.empty((bsz, t_len, n2r), dtype=f32, device=dev)
    if bsz == 0 or t_len == 0:
        return out
    lib = _dense_library()
    shapes = f"(B={bsz}, T={t_len}, F={f}, 2r={n2r}, K={k_layers})"
    with torch.cuda.device(dev):
        capacity = lib.drnmf_scan_dense_capacity(dense_batch_tile(bsz))
        if capacity < 1:
            why = ("the device has no cooperative launch, which orders the "
                   "phases across blocks" if capacity == 0 else
                   lib.drnmf_cuda_error_string(-capacity).decode())
            raise RuntimeError(f"drnmf_scan_dense cannot run here: {why} "
                               f"{shapes}")
        plan = dense_scan_plan(bsz, f, n2r, capacity)
        with span("scan.dense_stage"):
            x_t = x.new_zeros((t_len, plan.bp, plan.fp))
            x_t[:, :bsz, :f] = x.transpose(0, 1)
            state = x.new_zeros((4, plan.bp, plan.ld))
            state[0, :bsz, :n2r] = h0
            part = x.new_empty((plan.stretches, plan.bp, plan.ld))
            weights = (u1, uk, s_stack, w_stack)
            if plan.ld != n2r:  # rows of whole 16-byte copies, zero-padded
                weights = tuple(torch.nn.functional.pad(a, (0, plan.ld - n2r))
                                for a in weights)
        err = lib.drnmf_scan_dense(
            x_t.data_ptr(), step_mask.data_ptr(),
            *(a.data_ptr() for a in weights), b_stack.data_ptr(),
            state.data_ptr(), part.data_ptr(), out.data_ptr(), bsz, plan.bp,
            t_len, f, plan.fp, n2r, plan.ld, k_layers, plan.ni, plan.split,
            plan.grid, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.drnmf_cuda_error_string(err).decode()
        raise RuntimeError(f"drnmf_scan_dense launch failed: {msg} {shapes}, "
                           f"{plan}")
    LAUNCHES["dense"] += 1
    return out
