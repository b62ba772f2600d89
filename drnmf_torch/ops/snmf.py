"""Sparse NMF with beta-divergence, L1 sparsity and unit-L2 basis columns.

Counterpart of ``drnmf_tpu/ops/snmf.py`` (the reference's "well-done"
sparse NMF engine, Le Roux, Hershey & Weninger, MERL TR2015-023;
sparseNMF/sparse_nmf_gpu.m:1-304).  The update equations:

* H: ``h <- h * (W^T v) / max(W^T lam + sparsity, flr)`` (beta=2 shown);
* W: ``w <- w * (v h^T + w * sum(lam h^T . w)) / max(lam h^T + w * sum(v
  h^T . w), flr)``, the normalization-aware form, then column renorm;
* ``lam = max(W h, flr)``, ``flr = 1e-9``;
* frozen subsets through ``w_update_ind`` / ``h_update_ind``; beta = 0
  (IS), 1 (KL), 2 (ED) and any other; the objective history and the
  ``conv_eps`` relative-cost stop.

Routing (snmf.py:269-271 of the JAX package, by rule, with no knob): beta=2,
every ``h`` updated and a scalar sparsity go to :func:`ops.snmf_mu.
sparse_nmf_ed`, whose passes are kernels B4/B5 on the card and their plain
versions on the CPU; everything else runs :func:`_sparse_nmf_core`, a plain
PyTorch loop (the JAX package's XLA core).  Both take optional reductions
over ranks, through which ``parallel.mesh.sparse_nmf_sharded`` splits the
frames over a group.
"""

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import span
from .snmf_mu import FLR, converged, history, sparse_nmf_ed


@dataclass
class SNMFParams:
    """Mirrors the reference's params struct (sparse_nmf_gpu.m:74-170).

    ``cf`` in {'is', 'kl', 'ed'} overrides ``beta`` (0, 1, 2).  The fields
    other than the initial values and update masks name the dictionary:
    ``utils.cache.snmf_cache_path`` hashes them, as the JAX package does."""

    r: int = 100
    cf: str = "kl"
    beta: Optional[float] = None
    sparsity: float = 0.0
    max_iter: int = 100
    conv_eps: float = 0.0
    random_seed: int = 1
    init_w: Optional[np.ndarray] = None
    init_h: Optional[np.ndarray] = None  # an array, or "ones"
    w_update_ind: Optional[np.ndarray] = None  # bool (r,)
    h_update_ind: Optional[np.ndarray] = None  # bool (r,)

    def resolved_beta(self) -> float:
        if self.cf == "is":
            return 0.0
        if self.cf == "kl":
            return 1.0
        if self.cf == "ed":
            return 2.0
        return 1.0 if self.beta is None else float(self.beta)


@dataclass
class SNMFResult:
    w: object  # (m, r): numpy, or a tensor with device_output
    h: object  # (r, n): numpy, a tensor with device_output, or None
    div: np.ndarray  # objective divergence per iteration (n_iter of them)
    cost: np.ndarray  # divergence + sparsity penalty per iteration
    n_iter: int


def _h_update(v, w, h, lam, sparsity, h_mask, beta):
    if beta == 1.0:
        dph = w.sum(dim=0)[:, None] + sparsity
        dmh = w.T @ (v / lam)
    elif beta == 2.0:
        dph = w.T @ lam + sparsity
        dmh = w.T @ v
    else:
        dph = w.T @ lam ** (beta - 1.0) + sparsity
        dmh = w.T @ (v * lam ** (beta - 2.0))
    h_new = h * dmh / dph.clamp_min(FLR)
    return torch.where(h_mask[:, None], h_new, h)


def _w_statistics(v, w, h, lam, beta):
    """The W update's statistics, additive over frames: (m, r) and (m, r),
    or (m, r) and (r,) for beta=1."""
    if beta == 1.0:
        return (v / lam) @ h.T, h.sum(dim=1)
    if beta == 2.0:
        return v @ h.T, lam @ h.T
    return (v * lam ** (beta - 2.0)) @ h.T, lam ** (beta - 1.0) @ h.T


def _w_update_from_stats(w, stats, w_mask, beta):
    """The normalization-aware multiplicative W update from the statistics,
    then column renorm (sparse_nmf_gpu.m:232-264)."""
    a, b = stats
    if beta == 1.0:
        # a = (v/lam) h^T, b = sum(h, axis=1)
        c = (a * w).sum(dim=0)
        dpw = b[None, :] + c[None, :] * w
        dmw = a + (b[None, :] * w).sum(dim=0)[None, :] * w
    else:
        dpw = b + (a * w).sum(dim=0)[None, :] * w
        dmw = a + (b * w).sum(dim=0)[None, :] * w
    w_new = w * dmw / dpw.clamp_min(FLR)
    w = torch.where(w_mask[None, :], w_new, w)
    return w / (w * w).sum(dim=0, keepdim=True).sqrt()


def _divergence(v, lam, beta):
    if beta == 1.0:
        return (v * torch.log(v / lam) - v + lam).sum()
    if beta == 2.0:
        return ((v - lam) ** 2).sum()
    if beta == 0.0:
        return (v / lam - torch.log(v / lam) - 1.0).sum()
    return (v ** beta + (beta - 1.0) * lam ** beta
            - beta * v * lam ** (beta - 1.0)).sum() / (beta * (beta - 1.0))


def _sparse_nmf_core(v, w0, h0, sparsity, w_mask, h_mask, beta, max_iter,
                     conv_eps, reduce_sum=None, reduce_min=None):
    """The MU optimization of one frame chunk as a plain PyTorch loop.
    ``sparsity``: a 0-dim, (r, 1) or (r, n) tensor.  ``reduce_sum(*t)`` /
    ``reduce_min(t)``: where the frames are split over ranks, the sum (min)
    over them of the W statistics and the costs (of v's floor), so every
    rank runs the single-process iteration.  Returns
    ``(w, h, divs, costs, n_iter)`` with the ``n_iter`` iterations run."""
    reduce_sum = reduce_sum or (lambda *t: t)
    update_w = bool(w_mask.any())
    update_h = bool(h_mask.any())

    # normalize W's columns, rescale H to match (sparse_nmf_gpu.m:163-166)
    wn = (w0 * w0).sum(dim=0).sqrt()
    w = w0 / wn[None, :]
    h = h0 * wn[:, None]

    if beta != 2.0:
        # keep zero entries of v slightly positive (sparse_nmf_gpu.m:201-205)
        vmin = torch.where(v > 0, v, torch.inf).min()
        if reduce_min is not None:
            vmin = reduce_min(vmin)
        v = torch.where(v == 0, vmin, v)

    lam = (w @ h).clamp_min(FLR)
    divs, costs = [], []
    for _ in range(max_iter):
        if update_h:
            h = _h_update(v, w, h, lam, sparsity, h_mask, beta)
            lam = (w @ h).clamp_min(FLR)
        if update_w:
            stats = reduce_sum(*_w_statistics(v, w, h, lam, beta))
            w = _w_update_from_stats(w, stats, w_mask, beta)
            lam = (w @ h).clamp_min(FLR)
        div, sp = reduce_sum(_divergence(v, lam, beta), (sparsity * h).sum())
        cost = div + sp
        divs.append(div)
        costs.append(cost)
        if converged(costs, conv_eps):
            break
    return w, h, history(divs, v), history(costs, v), len(costs)


def _prepare(v_shape, params: SNMFParams, generator, device):
    """Initial W, H, sparsity and update masks on ``device``.  Random
    values come from ``generator`` (a ``torch.Generator`` on ``device``),
    W's first: a (1000 x 140,000) H is drawn on the card, not the host."""
    m, n = v_shape
    r = int(params.r)
    f32 = torch.float32

    def rand(*shape):
        return torch.rand(shape, generator=generator, dtype=f32,
                          device=device)

    if params.init_w is not None:
        init_w = torch.as_tensor(params.init_w, dtype=f32).to(device)
        ri = init_w.shape[1]
        if ri < r:
            w0 = torch.cat([init_w, rand(m, r - ri)], dim=1)
        else:
            # init_w wider than params.r: adopt r = ri, like the reference
            # (sparse_nmf_gpu.m:125-135 sets r to size(init_w, 2))
            r = ri
            w0 = init_w
    else:
        w0 = rand(m, r)
    if params.init_h is None:
        h0 = rand(r, n)
    elif isinstance(params.init_h, str) and params.init_h == "ones":
        h0 = torch.ones((r, n), dtype=f32, device=device)
    else:
        h0 = torch.as_tensor(params.init_h, dtype=f32).to(device)

    def mask(ind):
        if ind is None:
            return torch.ones((r,), dtype=torch.bool, device=device)
        return torch.as_tensor(np.asarray(ind, bool)).to(device)

    sparsity = torch.as_tensor(params.sparsity, dtype=f32).to(device)
    if sparsity.dim() == 1:
        sparsity = sparsity[:, None]
    return (w0.contiguous(), h0.contiguous(), sparsity,
            mask(params.w_update_ind), mask(params.h_update_ind))


def _solve(v, w0, h0, sparsity, w_mask, h_mask, params: SNMFParams,
           reduce_sum=None, reduce_min=None):
    """The routing rule of the module docstring on prepared operands:
    ``sparse_nmf_ed`` (B4/B5) or ``_sparse_nmf_core``.  The reductions: see
    ``_sparse_nmf_core``."""
    beta = params.resolved_beta()
    if (beta == 2.0 and bool(h_mask.all())
            and np.asarray(params.sparsity).size == 1):
        return sparse_nmf_ed(
            v, w0, h0, float(np.asarray(params.sparsity).reshape(-1)[0]),
            w_mask, max_iter=int(params.max_iter),
            conv_eps=float(params.conv_eps), reduce_sum=reduce_sum)
    return _sparse_nmf_core(
        v, w0, h0, sparsity, w_mask, h_mask, beta=beta,
        max_iter=int(params.max_iter), conv_eps=float(params.conv_eps),
        reduce_sum=reduce_sum, reduce_min=reduce_min)


def _to_numpy(t):
    return t.detach().cpu().numpy()


def sparse_nmf(v, params: SNMFParams, generator=None,
               device_output: bool = False, device="cuda") -> SNMFResult:
    """Sparse NMF of one frame chunk held on ``device``.  v: (m, n)
    nonnegative, numpy or a tensor.

    ``generator``: a ``torch.Generator`` on ``device`` for the random
    initial values (default: seeded with ``params.random_seed``).
    ``device_output=True`` leaves W and H as tensors on the device (H is
    (r, n): at corpus scale fetching it costs more than the solve); else
    they come back as numpy, H's fetch traced as the span
    ``snmf.h_to_host``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            int(params.random_seed))
    v = torch.as_tensor(v, dtype=torch.float32).to(device).contiguous()
    w0, h0, sparsity, w_mask, h_mask = _prepare(v.shape, params, generator,
                                                device)
    w, h, divs, costs, n_iter = _solve(v, w0, h0, sparsity, w_mask, h_mask,
                                       params)
    divs, costs = _to_numpy(divs), _to_numpy(costs)
    if device_output:
        return SNMFResult(w=w, h=h, div=divs, cost=costs, n_iter=n_iter)
    w = _to_numpy(w)
    with span("snmf.h_to_host"):
        h = _to_numpy(h)
    return SNMFResult(w=w, h=h, div=divs, cost=costs, n_iter=n_iter)


def default_frame_chunk(r: int, max_frames_at_r200: int = 700_000) -> int:
    """The reference's memory heuristic (snmf.py:33-36): frames per chunk
    scale as 1/r, anchored at 700k frames for r=200 on a 12 GB device.
    The chunk size is part of the result, so the anchor stays as it is on
    a card of 80 GB."""
    return int(float(max_frames_at_r200) * (200.0 / float(r)))


def sparse_nmf_chunked(v, params: SNMFParams, generator=None,
                       frame_chunk: Optional[int] = None,
                       save_h: bool = True, verbose: bool = False,
                       device="cuda", take_h=None) -> SNMFResult:
    """Frame-chunked sparse NMF with W warm-started between chunks.

    The reference's chunk loop (snmf.py:9-85): each chunk runs a full MU
    optimization; the learned (updatable columns of) W seed the next chunk;
    the chunks' first and last objective values are summed into a
    two-point [initial, final] objective.  ``v`` (m, n): numpy, or a tensor
    (on the device, chunks are sliced there).  ``generator``: as for
    :func:`sparse_nmf`, drawn from chunk after chunk.  With
    ``save_h=False`` H never leaves the device and the result's ``h`` is
    None.  ``take_h(cols, h)``, where given, takes the place of
    ``save_h``: it is handed each chunk's H on the device with the chunk's
    slice of ``v``'s columns, before the next chunk is solved, and H is
    not fetched.  The result's ``h`` is then that device tensor where the
    frames are one chunk, and None over several, so the device never holds
    more than one chunk's H."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            int(params.random_seed))
    if not isinstance(v, torch.Tensor):
        v = np.asarray(v)
    m, n = v.shape
    r = int(params.r)
    if params.init_w is not None and params.init_w.shape[1] > r:
        # _prepare adopts r = init_w's width; H and the chunk size follow
        r = int(params.init_w.shape[1])
    if frame_chunk is None:
        frame_chunk = default_frame_chunk(r)
    n_chunks = max(1, -(-n // frame_chunk))

    def solve(chunk, chunk_params, cols):
        res = sparse_nmf(chunk, chunk_params, generator=generator,
                         device_output=take_h is not None or not save_h,
                         device=device)
        if take_h is not None:
            take_h(cols, res.h)
            res = replace(res, w=_to_numpy(res.w),
                          h=res.h if n_chunks == 1 else None)
        elif not save_h:
            # only W leaves the device (H can be GBs at corpus scale)
            res = replace(res, w=_to_numpy(res.w), h=None)
        return res

    if n_chunks == 1:
        return solve(v, params, slice(0, n))

    h_full = (np.zeros((r, n), np.float32)
              if save_h and take_h is None else None)
    init_w = params.init_w
    w_ind = params.w_update_ind
    initial_cost = initial_div = final_cost = final_div = 0.0
    w = None
    for i in range(n_chunks):
        if verbose:
            print(f"sparse NMF: chunk {i + 1} of {n_chunks}")
        cols = slice(i * frame_chunk, (i + 1) * frame_chunk)
        # an explicit init_h is sliced to this chunk's frames
        init_h = params.init_h
        if init_h is not None and not isinstance(init_h, str):
            init_h = np.asarray(init_h)[:, cols]
        res = solve(v[:, cols], replace(params, init_w=init_w, init_h=init_h),
                    cols)
        if w_ind is not None and init_w is not None:
            init_w = np.array(init_w, np.float32, copy=True)
            if init_w.shape[1] < r:  # the first chunk grew W to full r
                init_w = res.w.copy()
            idx = np.where(np.asarray(w_ind))[0]
            init_w[:, idx] = res.w[:, idx]
        else:
            init_w = res.w
        w = res.w
        if h_full is not None:
            h_full[:, cols.start:cols.start + res.h.shape[1]] = res.h
        initial_cost += float(res.cost[0])
        initial_div += float(res.div[0])
        final_cost += float(res.cost[-1])
        final_div += float(res.div[-1])

    return SNMFResult(
        w=w, h=h_full,
        div=np.array([initial_div, final_div], np.float32),
        cost=np.array([initial_cost, final_cost], np.float32),
        n_iter=int(params.max_iter))
