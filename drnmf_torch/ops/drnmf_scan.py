"""Kernels B1, B2 and B3: the DR-NMF recurrence on an H100.

- B1, ``drnmf_scan_factored``: the folded-U + factored-S recurrence.
  Replaces ``drnmf_tpu/ops/pallas/drnmf_scan.py::_kernel_factored`` (entry
  ``drnmf_scan_pallas_factored``).  CUDA C++ in
  ``csrc/drnmf_scan_factored.cu``.
- B2, ``drnmf_scan_factored(..., interleave=True)``: the same function with
  two independent groups of rows a block, a second ``__global__`` entry of
  the same source.  Replaces ``_kernel_factored_interleaved``.
- B3, ``drnmf_scan_dense``: the recurrence with dense (2r, 2r) U and S
  matrices, for a model whose U trains or whose checkpoint breaks the
  fold's structure.  Replaces ``_kernel`` (entry ``drnmf_scan_pallas``).
  CUDA C++ in ``csrc/drnmf_scan_dense.cu``.

All are built for ``sm_90a`` at first use (see ``build.py``).

What bounds them on the card.  B1/B2: per batch row and step
2·F·2r·(2K−1) flops against about one byte of compulsory traffic per flop,
so the f32 rate of the CUDA cores.  One launch runs the whole scan; blocks
split the batch (two rows each, or two groups of two), keep the carry,
hidden state and residual in shared memory and stream the weights from L2,
re-reading the stack at every step: this first version is bound by each
SM's own load path (a step takes the same 0.4 ms whether 1, 32 or 128
blocks run: 18.5 MB through one SM, about 45 GB/s), not by L2's aggregate
rate.  B3: 2·(2r)²·(2K−1) + 2·F·2r·K flops per row and step against a
weight stack (106 MB at the flagship) that fits no cache, so operations at
a large batch and the weight reads from HBM at a few rows.  One cooperative
launch runs the whole scan; each layer is one tiled product whose output
tiles are spread over the blocks, with a grid synchronisation per layer, so
each weight is read once per row tile and step.  The source notes in the
``.cu`` files give the trade-offs.

Each wrapper launches its kernel for CUDA tensors or raises; for CPU
tensors it runs the plain version beside it
(``drnmf_scan_factored_reference``, ``drnmf_scan_dense_reference``), which
is the same function in eager PyTorch and the reference the kernel is held
against.
"""

import ctypes
import functools

import torch

from . import build

SOURCE = "drnmf_scan_factored.cu"  # B1 and B2
DENSE_SOURCE = "drnmf_scan_dense.cu"  # B3
# kernel launches since the last reset, by kernel; chip_smoke.py reads them
# to show that the main path went through the kernels
LAUNCHES = {"factored": 0, "interleaved": 0, "dense": 0}
# output tile sides the dense kernel is built for
DENSE_TILES = (16, 32, 64)


@functools.cache
def _library():
    lib = build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.drnmf_scan_factored, lib.drnmf_scan_factored_interleaved):
        fn.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
        fn.restype = i32
    lib.drnmf_cuda_error_string.argtypes = [i32]
    lib.drnmf_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _dense_library():
    lib = build.load(DENSE_SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.drnmf_scan_dense.argtypes = [ptr] * 9 + [i32] * 9 + [ptr]
    lib.drnmf_scan_dense.restype = i32
    lib.drnmf_scan_dense_capacity.argtypes = [i32, i32]
    lib.drnmf_scan_dense_capacity.restype = i32
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


def drnmf_scan_factored(x, step_mask, h0, diag1, off1, c_uk, dkt_stack,
                        dka_stack, b_stack, interleave: bool = False):
    """Folded + factored recurrence over the whole sequence.

    x (B, T, F) f32; step_mask (B, T) bool (True = valid step); h0 (B, 2r);
    diag1 (2r,); off1, c_uk 0-dim or 1-element f32 tensors;
    dkt_stack (K-1, 2r, F) = Dhat_k^T (a dummy (1, 2r, F) when K == 1);
    dka_stack (K, F, 2r) = Dhat_k/alph_k; b_stack (K, 2r).
    Returns the hidden states (B, T, 2r) f32; masked steps hold the carry.
    ``interleave``: on the card, launch the interleaved entry (kernel B2:
    two independent groups of rows a block) instead of B1's; the function
    computed is the same, for any B.
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
    name = "interleaved" if interleave else "factored"
    entry = (lib.drnmf_scan_factored_interleaved if interleave
             else lib.drnmf_scan_factored)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(
            x.data_ptr(), step_mask.data_ptr(), h0.data_ptr(),
            diag1.data_ptr(), off1.data_ptr(), c_uk.data_ptr(),
            dkt_stack.data_ptr(), dka_stack.data_ptr(), b_stack.data_ptr(),
            out.data_ptr(), bsz, t_len, f, n2r, k_layers, stream)
    if err != 0:
        msg = lib.drnmf_cuda_error_string(err).decode()
        raise RuntimeError(f"drnmf_scan_factored ({name}) launch failed: "
                           f"{msg} (B={bsz}, T={t_len}, F={f}, 2r={n2r}, "
                           f"K={k_layers})")
    LAUNCHES[name] += 1
    return out


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


def dense_scan_tiles(bsz: int, n2r: int, n_blocks: int):
    """The dense kernel's output tile (rows, columns) for this batch and
    width on a card that keeps ``n_blocks`` blocks resident.  Rows: the
    smallest built side that covers the batch (64 at most).  Columns: the
    side with the least rounds x width, the time of a layer when every
    resident block works on one tile a round; the wider side on a tie (it
    re-reads the activations less)."""
    tm = next((s for s in DENSE_TILES if s >= bsz), DENSE_TILES[-1])
    row_tiles = -(-bsz // tm)

    def cost(tn):
        return -(-(row_tiles * -(-n2r // tn)) // max(1, n_blocks)) * tn

    tn = min(reversed(DENSE_TILES), key=cost)
    return tm, tn


def drnmf_scan_dense(x, step_mask, h0, u1, uk, s_stack, w_stack, b_stack):
    """Dense-U recurrence over the whole sequence (kernel B3).

    x (B, T, F) f32; step_mask (B, T) bool (True = valid step); h0 (B, 2r);
    u1, uk (2r, 2r); s_stack (K-1, 2r, 2r) (a dummy (1, 2r, 2r) when K == 1,
    never read); w_stack (K, F, 2r); b_stack (K, 2r).  Per step
    ``hid_k = relu(h @ U_k + hid_{k-1} @ S_{k-1} + x_t @ W_k + b_k)`` with
    ``U_0 = u1`` and ``U_{k>0} = uk``.  Returns the hidden states
    (B, T, 2r) f32; masked steps hold the carry.

    On the card the kernel needs a device with cooperative launch and room
    for one resident block; the wrapper raises otherwise.  It allocates the
    kernel's scratch: x with the batch innermost and padded to the row tile
    (T, F, Bp), and four (2r, Bp) activation planes.
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
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        tm, tn = dense_scan_tiles(bsz, n2r, n_sm)
        capacity = lib.drnmf_scan_dense_capacity(tm, tn)
        if capacity < 1:
            why = ("the device has no cooperative launch, which orders the "
                   "layers across blocks" if capacity == 0 else
                   lib.drnmf_cuda_error_string(-capacity).decode())
            raise RuntimeError(f"drnmf_scan_dense cannot run here: {why} "
                               f"{shapes}")
        bp = -(-bsz // tm) * tm
        x_t = x.new_zeros((t_len, f, bp))
        x_t[:, :, :bsz] = x.permute(1, 2, 0)
        state = x.new_zeros((4, n2r, bp))
        state[0, :, :bsz] = h0.T
        grid = min((bp // tm) * -(-n2r // tn), capacity)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.drnmf_scan_dense(
            x_t.data_ptr(), step_mask.data_ptr(), u1.data_ptr(),
            uk.data_ptr(), s_stack.data_ptr(), w_stack.data_ptr(),
            b_stack.data_ptr(), state.data_ptr(), out.data_ptr(), bsz, bp,
            t_len, f, n2r, k_layers, tm, tn, grid, stream)
    if err != 0:
        msg = lib.drnmf_cuda_error_string(err).decode()
        raise RuntimeError(f"drnmf_scan_dense launch failed: {msg} {shapes}, "
                           f"tile {tm}x{tn}, grid {grid}")
    LAUNCHES["dense"] += 1
    return out
