"""Process groups and layouts over ranks (counterpart of
``drnmf_tpu/parallel/mesh.py``).

Where the JAX package lays one program over a device mesh, the port runs
one process a rank under ``torch.distributed``:

* :func:`init_group` joins a rank to its group: a ``FileStore`` in a
  directory the launcher made (no port is opened), a timeout on every
  collective, and the backend by rule: ``nccl`` where every rank has a
  card of its own, ``gloo`` where ranks share a card or run on the CPU.
  :func:`run_ranks` starts the ranks (spawned processes) and joins them
  with a deadline.
* :func:`make_mesh` / :func:`make_mesh_2d` describe the layout: ``dp``
  data-parallel groups and ``tp`` tensor-parallel groups, rank ``i_dp *
  n_tp + i_tp`` (tp varies fastest, as in the JAX package), each rank's
  device ``cuda:{rank % device_count}``.
* :class:`Mesh` owns the collectives the port uses (sum, min, gather,
  reduce-scatter, broadcast over ``dp``, ``tp`` or the world) and counts
  the bytes each moves.  gloo in the card's PyTorch (2.11) takes CUDA
  tensors for every one of them and stages them through host memory
  itself, so no collective here stages by hand.  ``Mesh.local`` is one
  process with no group, on which every collective returns its inputs.
* :func:`shard_rows` cuts a batch into contiguous row blocks (``P("dp")``),
  a partial batch padded with zero-mask rows; :func:`replicate_params`
  and :func:`fsdp_shard_params` place parameters, the latter by the FSDP
  rule of :func:`fsdp_shard_dim`, which ``utils/memplan.py`` shares.
* :func:`sparse_nmf_sharded`: frames split over the ranks, every W
  statistic summed, so each rank holds the single-process dictionary.
"""

import datetime
import os
import pickle
import shutil
import tempfile
import time
from dataclasses import replace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device of a rank: ``cuda:{rank % device_count}`` on the card,
    the CPU when asked for it.  Raises where CUDA was asked for and is
    absent."""
    from ..device import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def backend_for(world: int, device) -> str:
    """``nccl`` where each of the ``world`` ranks has a card of its own;
    ``gloo`` where ranks share a card (NCCL refuses two ranks of one
    communicator on one device) or run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_group(rank: int, world: int, store_path: str, device="cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join rank ``rank`` of ``world`` to the default process group through
    the ``FileStore`` at ``store_path``; returns the rank's device (set as
    the current CUDA device on the card)."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend_for(world, dev), store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _rank_main(rank, fn, world, store_path, device, timeout_s, out_dir,
               threads, args):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(threads)
    init_group(rank, world, store_path, device, timeout_s)
    try:
        result = fn(rank, *args)
        with open(os.path.join(out_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, args=(), device="cuda",
              timeout_s: float = DEFAULT_TIMEOUT_S,
              deadline_s: Optional[float] = None):
    """Run ``fn(rank, *args)`` in ``world`` spawned processes joined in one
    group (:func:`init_group`); returns their results by rank.  ``fn`` and
    ``args`` are pickled (``fn`` by import path) and so are the results.
    Collectives time out after ``timeout_s``; where ``deadline_s`` is given
    the ranks are killed and ``TimeoutError`` raised if they have not all
    ended by then.  Ranks on the CPU share the caller's intra-op threads
    (``torch.get_num_threads()`` here, at least one a rank).  A rank's
    exception is raised here."""
    import torch.multiprocessing as mp

    threads = max(1, torch.get_num_threads() // world)
    tmp = tempfile.mkdtemp(prefix="drnmf_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main, nprocs=world, join=False, start_method="spawn",
            args=(fn, world, os.path.join(tmp, "store"), str(device),
                  timeout_s, tmp, threads, args))
        start = time.monotonic()
        while not ctx.join(timeout=1.0):
            if deadline_s is not None and (time.monotonic() - start
                                           > deadline_s):
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks did not end within "
                                   f"{deadline_s:.0f} s")
        out = []
        for rank in range(world):
            with open(os.path.join(tmp, f"result_{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class Mesh:
    """This rank's place in a ``dp x tp`` layout over the default group,
    and the collectives over its axes (``"dp"``, ``"tp"`` or ``"world"``).
    ``traffic[axis]`` counts the bytes each rank handed to collectives on
    that axis, ``calls[axis]`` the collectives."""

    def __init__(self, n_dp: int, n_tp: int, device: torch.device):
        if not dist.is_initialized():
            raise RuntimeError("no process group: call init_group first")
        world = dist.get_world_size()
        if n_dp * n_tp != world:
            raise ValueError(f"a {n_dp} x {n_tp} layout needs "
                             f"{n_dp * n_tp} ranks, the group has {world}")
        self._place(n_dp, n_tp, dist.get_rank(), world, device,
                    dist.get_backend())
        # every rank creates every subgroup, in the same order
        if n_tp > 1:
            for i_tp in range(n_tp):
                g = dist.new_group([i * n_tp + i_tp for i in range(n_dp)])
                if i_tp == self.i_tp:
                    self._groups["dp"] = g
            for i_dp in range(n_dp):
                g = dist.new_group([i_dp * n_tp + i for i in range(n_tp)])
                if i_dp == self.i_dp:
                    self._groups["tp"] = g

    @classmethod
    def local(cls, device) -> "Mesh":
        """One process and no process group (a fit without a mesh): every
        axis has size 1, so every collective returns its inputs."""
        mesh = cls.__new__(cls)
        mesh._place(1, 1, 0, 1, device, None)
        return mesh

    def _place(self, n_dp, n_tp, rank, world, device, backend):
        self.n_dp, self.n_tp, self.rank, self.world = n_dp, n_tp, rank, world
        self.i_dp, self.i_tp = divmod(rank, n_tp)
        self.device = torch.device(device)
        self.backend = backend
        n_cards = (torch.cuda.device_count() if self.device.type == "cuda"
                   else 0)
        # ranks that share this rank's card (1 on the CPU)
        self.ranks_per_device = -(-world // n_cards) if n_cards else 1
        self._groups = {"world": None, "dp": None, "tp": None}
        self.traffic = {"dp": 0, "tp": 0, "world": 0}
        self.calls = {"dp": 0, "tp": 0, "world": 0}

    def size(self, axis: str) -> int:
        return {"dp": self.n_dp, "tp": self.n_tp, "world": self.world}[axis]

    def index(self, axis: str) -> int:
        return {"dp": self.i_dp, "tp": self.i_tp, "world": self.rank}[axis]

    def describe(self) -> str:
        shared = (f", {self.ranks_per_device} ranks a card"
                  if self.ranks_per_device > 1 else "")
        return (f"dp={self.n_dp} x tp={self.n_tp} over {self.world} ranks, "
                f"backend {self.backend}, {self.device.type}{shared}")

    def _count(self, axis, t):
        self.traffic[axis] += t.numel() * t.element_size()
        self.calls[axis] += 1

    def reduce(self, *tensors, axis="dp", op="sum"):
        """The tensors reduced elementwise (``op``: sum, min or max) over
        the ranks of ``axis``, as new tensors; one collective for all of
        them (same dtype)."""
        if self.size(axis) == 1:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self._count(axis, flat)
        dist.all_reduce(flat, op=_OPS[op], group=self._groups[axis])
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].view(t.shape))
            at += t.numel()
        return tuple(out)

    def gather(self, t, axis="dp", dim=0):
        """``t`` of every rank of ``axis`` (equal shapes), concatenated
        along ``dim`` in rank order."""
        n = self.size(axis)
        if n == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        self._count(axis, t)
        dist.all_gather(parts, t, group=self._groups[axis])
        return torch.cat(parts, dim=dim)

    def gather_uneven(self, t, sizes, axis="dp", dim=0):
        """As :meth:`gather`, where rank ``i`` holds ``sizes[i]`` entries
        along ``dim`` (known to every rank)."""
        n = self.size(axis)
        if n == 1:
            return t
        top = max(sizes)
        pad = list(t.shape)
        pad[dim] = top - t.shape[dim]
        full = self.gather(torch.cat([t, t.new_zeros(pad)], dim=dim), axis,
                           dim)
        return torch.cat([full.narrow(dim, i * top, s)
                          for i, s in enumerate(sizes)], dim=dim)

    def reduce_scatter(self, t, axis="dp", dim=0):
        """The sum of ``t`` over the ranks of ``axis``, of which this rank
        keeps its block along ``dim`` (``dim`` divisible by the ranks)."""
        n = self.size(axis)
        if n == 1:
            return t
        parts = [p.contiguous() for p in t.chunk(n, dim=dim)]
        out = torch.empty_like(parts[0])
        self._count(axis, t)
        dist.reduce_scatter(out, parts, group=self._groups[axis])
        return out

    def broadcast(self, t, src=0):
        """``t`` as rank ``src`` holds it, on every rank (in place)."""
        if self.world > 1:
            self._count("world", t)
            dist.broadcast(t, src)
        return t

    def barrier(self):
        if self.world > 1:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()

    def rank0_first(self, fn):
        """``fn(True)`` on rank 0, then ``fn(False)`` on the other ranks:
        what it writes on rank 0 (caches, files) is there when the others
        look, and they read it rather than compute it again."""
        if self.rank == 0:
            out = fn(True)
            self.barrier()
            return out
        self.barrier()
        return fn(False)


def make_mesh(n: Optional[int] = None, device=None) -> Mesh:
    """A data-parallel layout over the whole group (``n`` ranks if given,
    which must be the group's size)."""
    world = dist.get_world_size()
    return Mesh(world if n is None else n, 1, _device_of(device))


def make_mesh_2d(n_dp: int, n_tp: int, device=None) -> Mesh:
    """A ``dp x tp`` layout, tp varying fastest (``rank = i_dp * n_tp +
    i_tp``)."""
    return Mesh(n_dp, n_tp, _device_of(device))


def _device_of(device):
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_rows(n_rows: int, mesh: Optional[Mesh]):
    """``(start, stop, per)`` of this rank's rows of a batch of ``n_rows``:
    the batch padded to ``per * n_dp`` rows and cut into contiguous blocks
    of ``per``; rows ``[start, stop)`` are real, the rest of the block is
    padding (zero rows, zero mask)."""
    if mesh is None:
        return 0, n_rows, n_rows
    per = -(-n_rows // mesh.n_dp)
    start = min(mesh.i_dp * per, n_rows)
    return start, min(start + per, n_rows), per


def pad_block(arrays, per: int):
    """Each array (numpy or tensors) with zero rows appended up to ``per``
    rows."""
    out = []
    for a in arrays:
        if a.shape[0] < per:
            pad = (per - a.shape[0],) + tuple(a.shape[1:])
            if isinstance(a, torch.Tensor):
                a = torch.cat([a, torch.zeros(pad, dtype=a.dtype,
                                              device=a.device)])
            else:
                a = np.concatenate([a, np.zeros(pad, a.dtype)])
        out.append(a)
    return tuple(out)


def shard_batch(arrays, mesh: Optional[Mesh]):
    """This rank's rows of each array of a batch (numpy or tensors), the
    block padded with zero rows to the rank's share (:func:`shard_rows`)."""
    start, stop, per = shard_rows(arrays[0].shape[0], mesh)
    return pad_block(tuple(a[start:stop] for a in arrays), per)


def replicate_params(params: dict, mesh: Mesh) -> dict:
    """Rank 0's parameters on every rank: float32 copies on the rank's
    device, broadcast over the world group."""
    from ..device import params_on_device

    out = {k: v.clone() for k, v in params_on_device(params, mesh.device)
           .items()}
    for k in sorted(out):
        mesh.broadcast(out[k])
    return out


def fsdp_shard_dim(shape, n: int, min_elems: int = 1 << 16):
    """The FSDP rule (``drnmf_tpu/parallel/mesh.py::fsdp_param_sharding``):
    the dimension of a tensor of ``shape`` sharded over ``n`` ranks -- its
    largest dimension divisible by ``n``, the first of equals -- or None
    (replicated) for a tensor under ``min_elems`` elements, with no such
    dimension, or ``n <= 1``."""
    shape = tuple(int(s) for s in shape)
    total = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if n <= 1 or total < min_elems:
        return None
    cands = [d for d in range(len(shape)) if shape[d] % n == 0]
    if not cands:
        return None
    return max(cands, key=lambda d: shape[d])


def fsdp_param_sharding(value, mesh: Mesh, min_elems: int = 1 << 16):
    """The dp-sharded dimension of ``value`` under the FSDP rule, or None."""
    return fsdp_shard_dim(tuple(value.shape), mesh.n_dp, min_elems)


def fsdp_shard(value, dim, mesh: Mesh):
    """This rank's block of ``value`` along ``dim`` (contiguous), or
    ``value`` itself where ``dim`` is None."""
    if dim is None:
        return value
    return value.chunk(mesh.n_dp, dim=dim)[mesh.i_dp].contiguous()


def fsdp_shard_params(params: dict, mesh: Mesh, min_elems: int = 1 << 16):
    """Place a parameter dict under the FSDP rule: ``(shards, dims)`` with
    this rank's block of each sharded tensor (float32 on its device) and
    each tensor's sharded dimension (None: replicated)."""
    full = replicate_params(params, mesh)
    dims = {k: fsdp_param_sharding(v, mesh, min_elems)
            for k, v in full.items()}
    return {k: fsdp_shard(v, dims[k], mesh) for k, v in full.items()}, dims


# ---------------------------------------------------------------------------
# sparse NMF with frames split over the ranks
# ---------------------------------------------------------------------------

def frame_block(n: int, size: int, i: int):
    """``[c0, c1)``: the frames of rank ``i`` of ``size`` out of ``n``,
    contiguous, the counts differing by at most one (no padding, no frame
    mask)."""
    return n * i // size, n * (i + 1) // size


def sparse_nmf_sharded(v, params, mesh: Mesh, generator=None,
                       axis="dp"):
    """Sparse NMF with the frames (columns of ``v`` (m, n), numpy or a
    tensor, the same on every rank) split over the ranks of ``axis``.

    Every rank draws the full initial H from the same generator (default:
    seeded with ``params.random_seed``) and keeps its columns, so the run
    does not depend on the number of ranks; a given ``init_h`` is sliced on
    the host.  The W update's statistics, the divergence and the sparsity
    cost are summed over the ranks (and beta != 2's floor of v is the
    minimum over them), so every rank holds the dictionary and the cost
    series of the single-process ``ops.snmf.sparse_nmf``, and all stop at
    the same iteration.  beta=2 with every H row updated and a scalar
    sparsity runs kernels B4/B5 on each rank's frames (on the card), as the
    single-process route does.  Returns an ``SNMFResult`` whose ``h`` is
    gathered whole."""
    from ..ops.snmf import SNMFResult, _prepare, _solve, _to_numpy

    device = mesh.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            int(params.random_seed))
    v = torch.as_tensor(v, dtype=torch.float32)
    m, n = v.shape
    size = mesh.size(axis)
    c0, c1 = frame_block(n, size, mesh.index(axis))
    if params.init_h is None:
        w0, h0, sparsity, w_mask, h_mask = _prepare((m, n), params,
                                                    generator, device)
        h0 = h0[:, c0:c1].contiguous()
    else:
        if not isinstance(params.init_h, str):
            params = replace(params, init_h=np.asarray(
                params.init_h, np.float32)[:, c0:c1])
        w0, h0, sparsity, w_mask, h_mask = _prepare((m, c1 - c0), params,
                                                    generator, device)
    if sparsity.dim() == 2 and sparsity.shape[1] == n and n > 1:
        sparsity = sparsity[:, c0:c1].contiguous()
    v_local = v[:, c0:c1].to(device).contiguous()

    def reduce_sum(*tensors):
        return mesh.reduce(*tensors, axis=axis)

    def reduce_min(t):
        return mesh.reduce(t, axis=axis, op="min")[0]

    w, h, divs, costs, n_iter = _solve(v_local, w0, h0, sparsity, w_mask,
                                       h_mask, params, reduce_sum,
                                       reduce_min)
    sizes = [b - a for a, b in (frame_block(n, size, i)
                                for i in range(size))]
    h = mesh.gather_uneven(h, sizes, axis=axis, dim=1)
    return SNMFResult(w=_to_numpy(w), h=_to_numpy(h), div=_to_numpy(divs),
                      cost=_to_numpy(costs), n_iter=n_iter)
