"""Training loop (counterpart of ``drnmf_tpu/train/loop.py``): Keras-style
Adam with per-parameter trainability, early stopping, best-only
checkpointing and the full metric history.

What it keeps of the JAX loop:

* Adam(lr, clipnorm, decay) in optax's arithmetic (``KerasAdam``): b1 0.9,
  b2 0.999, eps 1e-8 outside the root, the learning rate ``lr / (1 +
  decay * step)`` with ``step`` counted from 0, and ``clipnorm > 0``
  scaling the gradients of the trainable parameters by ``c / ||g||`` when
  their global norm reaches ``c``.
* Frozen parameters are not handed to the optimizer: they get no update
  and keep their bits.
* The batch order of each epoch is ``np.random.default_rng(seed)
  .permutation(n)`` cut into batches, the ragged last one kept.
* Each step's loss goes into one buffer on the device, read once an epoch.
* ``val_loss`` from ``eval_loss_fn`` (or ``loss_fn``) without dropout, in
  batches of 250 weighted by valid frames; early stopping once ``wait >
  patience``; the best parameters written as ``.npz`` with ``val_loss`` in
  the meta after every epoch that improved (what the JAX loop writes at its
  default); ``epochs == 0`` writes the initial values with ``val_loss =
  inf``.
* With ``loss_takes_rng`` the loss gets a ``torch.Generator`` seeded from
  ``train_config.seed`` and the global step (dropout).

Both splits go to the device once when they take at most
``DEVICE_DATA_SHARE`` of its free memory; a batch is then gathered there.
Otherwise each batch is gathered on the host and copied through pinned
memory without blocking, the next one while the current step runs.

Elastic resume (``resume=True`` with a ``savefile``): after each epoch the
whole training state goes to ``savefile + ".train_state"`` (written to a
temporary file and renamed): the trainable parameters, ``KerasAdam``'s
``mu``, ``nu`` and ``count``, the best parameters and loss, the
early-stopping counter, the epoch and the global step.  Frozen parameters
are left out and checked at load against a fingerprint of the caller's
(:func:`_frozen_fingerprint`).  A run that finds the file continues as if
it had never stopped: the host order is fast-forwarded by the epochs run,
and dropout's generator is seeded from the restored global step.
``DRNMF_STATE_EVERY=N`` writes the best checkpoint and the state every N
epochs (and at the last, at an early stop and at a deadline) instead of
every epoch; ``DRNMF_TRAIN_DEADLINE_TS`` (a unix time) stops a resumable
fit at the first epoch boundary past it with :class:`TrainingDeadline`,
its state on disk.  The state file is the port's own (the JAX package's
holds optax's leaves); a ``.npz`` checkpoint moves between the packages.

With ``mesh`` (``parallel.mesh``) the fit runs on every rank of the mesh
and gives the single-process fit at the same global batch (the JAX
package's ``mesh=``/``fsdp=``):

* Each global batch (the same order on every rank) is cut into contiguous
  row blocks over ``dp``, a partial batch padded with zero-mask rows
  (``shard_rows``).  The losses are masked means over the global batch,
  so each rank's loss is scaled by its share of the batch's valid frames
  (counted from the global batch, which every rank holds) and the
  gradients are summed over ``dp``, not averaged as DDP does: equal
  wherever ranks hold different valid-frame counts.  The losses recorded
  are the global batch's.
* Dropout: every rank draws the global batch's masks from
  ``_step_seed(seed, step)`` and keeps its rows (``models.drnmf.
  BatchRows``), so the fit does not depend on the number of ranks.
* ``fsdp=True`` keeps on each rank its block of every tensor that the FSDP
  rule shards (``parallel.mesh.fsdp_shard_dim``) and of its Adam moments;
  the parameters are gathered before each forward, the gradients
  reduce-scattered after the backward, and Adam steps on the blocks.
  ``clipnorm`` takes the norm of the global gradient: the sharded squares
  summed over ``dp``, each replicated tensor counted once.
* ``evaluate`` sums the weighted losses over ``dp``; rank 0 alone writes
  the history, the checkpoints and the resume state (gathered whole, in
  the single-process format, so a fit resumes at any number of ranks),
  the others wait at a barrier.  The splits stay on the card when they
  take at most ``DEVICE_DATA_SHARE`` of its free memory divided by the
  ranks that share it.
* Under a tp axis the loss's own collectives complete each gradient within
  the tp group (``parallel.tensor_parallel``); the loop sums over ``dp``.

Not ported: XLA's devices (buffer donation, ``make_epoch_chunk``,
``DRNMF_EPOCH_FUSE*``).
"""

import os
import pickle
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..device import free_bytes, resolve_device
from ..models.drnmf import BatchRows
from ..parallel.mesh import (Mesh, fsdp_shard_params, pad_block,
                             replicate_params, shard_batch, shard_rows)
from .checkpoint import save_checkpoint
from .history import LossHistory
from .losses import _step_weights

# the splits stay on the card when they take at most this share of its free
# memory; the rest is left to the train step (the recurrence's residuals
# alone are 1.28 GB at the flagship schedule)
DEVICE_DATA_SHARE = 0.5
EVAL_BATCH = 250


def _frozen_fingerprint(value):
    """A cheap content fingerprint of a frozen parameter (shape, float64 sum
    and absolute sum).  Frozen values are not stored in the train state but
    taken from the caller's parameters at load: a fit resumed from another
    dictionary or initialisation must not mix them silently with the
    stored trainable state."""
    v = np.asarray(value, np.float64)
    return (tuple(v.shape), float(v.sum()), float(np.abs(v).sum()))


class TrainingDeadline(RuntimeError):
    """Raised at an epoch boundary once the unix time in
    ``DRNMF_TRAIN_DEADLINE_TS`` has passed and the fit's resume state is on
    disk: a bounded run stops cleanly, and a later call resumes it."""


def _read_state(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def train_state_incomplete(savefile, epochs, patience):
    """True where the resume state of ``savefile`` belongs to a fit that
    still has epochs to run (it neither stopped early nor reached
    ``epochs``): the pipeline then trains although a best checkpoint
    exists."""
    path = savefile + ".train_state"
    if not os.path.exists(path):
        return False
    state = _read_state(path)
    if state.get("finished") or state["wait"] > patience:
        return False
    return state["epoch"] + 1 < epochs


def _save_train_state(path, epoch, params, opt, best_params, best_val,
                      wait, global_step, frozen, finished=False):
    """The whole training state, written to a temporary file and renamed.
    ``params``: name -> full tensor; ``opt``: ``KerasAdam.state_dict()``
    with full moments; ``frozen``: name -> host array of the frozen
    parameters, stored only as fingerprints."""

    def host(v):
        return v.detach().cpu().numpy().copy()

    state = {
        "epoch": epoch,
        "params": {k: host(v) for k, v in params.items() if k not in frozen},
        "opt": {"names": list(opt["names"]), "count": opt["count"],
                "mu": [host(m) for m in opt["mu"]],
                "nu": [host(m) for m in opt["nu"]]},
        "best_params": {k: np.asarray(v) for k, v in best_params.items()
                        if k not in frozen},
        "frozen_fingerprint": {k: _frozen_fingerprint(v)
                               for k, v in sorted(frozen.items())},
        "best_val": float(best_val),
        "wait": int(wait),
        "global_step": int(global_step),
        "finished": bool(finished),
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f)
    os.replace(tmp, path)


def _load_train_state(path, names, frozen):
    """The state of ``path``, checked against this fit (the trained
    ``names``; ``frozen``: the caller's frozen values, by fingerprint), with
    the best parameters completed by ``frozen``."""
    state = _read_state(path)
    stored = state["frozen_fingerprint"]
    if set(stored) != set(frozen):
        raise ValueError(
            f"train state {path} froze {sorted(stored)}, this fit freezes "
            f"{sorted(frozen)}: delete the train state to restart")
    for k, want in stored.items():
        got = _frozen_fingerprint(frozen[k])
        if got != want:
            raise ValueError(
                f"frozen param '{k}' differs from the run that wrote {path} "
                f"(fingerprint {got} != {want}): resuming would silently mix "
                f"a different warm-start dictionary/init with the "
                f"checkpointed trainable state. Delete the train state to "
                f"restart, or restore the original initialization.")
    if state["opt"]["names"] != names:
        raise ValueError(f"train state {path} trains "
                         f"{state['opt']['names']}, this fit {names}")
    state["best_params"] = {**frozen, **state["best_params"]}
    return state


@dataclass
class TrainConfig:
    epochs: int = 100
    batch_size: int = 32
    learning_rate: float = 1e-3
    clipnorm: float = 0.0
    decay: float = 0.0
    patience: int = 50
    seed: int = 7654
    verbose: bool = True


class KerasAdam:
    """Adam with Keras 2.0.4's decay and clipnorm, in the order of the JAX
    package's optax chain (``make_optimizer``): clip by the global norm
    (``g / ||g|| * c`` unless ``||g|| < c``; the norm summed over the
    parameters in name order, as a dict's leaves are), then ``mu = (1 -
    b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, the update ``(mu / (1 -
    b1^n)) / (sqrt(nu / (1 - b2^n)) + eps)`` scaled by ``-lr / (1 + decay
    * (n - 1))`` at the n-th step.  A parameter with no gradient steps on
    zeros, as a JAX leaf with a zero gradient does.  Everything stays on
    the device: no host synchronisation a step.  ``grad_norm_sq(grads)``:
    the squared global norm where the parameters held are blocks of
    others (FSDP); by default the sum of the squares held."""

    def __init__(self, params: dict, train_config: TrainConfig,
                 grad_norm_sq: Optional[Callable] = None):
        self.names = sorted(params)
        self.params = [params[k] for k in self.names]
        self.lr = float(train_config.learning_rate)
        self.decay = float(train_config.decay)
        self.clipnorm = float(train_config.clipnorm or 0.0)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.grad_norm_sq = grad_norm_sq or (
            lambda grads: sum(torch.sum(g * g) for g in grads))

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def state_dict(self):
        return {"names": self.names, "count": self.count, "mu": self.mu,
                "nu": self.nu}

    @torch.no_grad()
    def step(self, grads=None):
        """One update from ``grads`` (in ``names`` order; by default each
        parameter's ``.grad``)."""
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        if self.clipnorm > 0:
            norm = torch.sqrt(self.grad_norm_sq(grads))
            keep = norm < self.clipnorm
            grads = [torch.where(keep, g, g / norm * self.clipnorm)
                     for g in grads]
        lr = self.lr / (1.0 + self.decay * self.count)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            torch.add(g * (1.0 - self.b1), mu, alpha=self.b1, out=mu)
            torch.add(g * g * (1.0 - self.b2), nu, alpha=self.b2, out=nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(update * -lr)


def make_optimizer(train_config: TrainConfig, params: dict,
                   trainable_mask: Optional[dict] = None,
                   grad_norm_sq: Optional[Callable] = None) -> KerasAdam:
    """Keras-Adam over the trainable entries of ``params`` (name -> leaf
    tensor); the frozen ones are left out and never written."""
    if trainable_mask is not None:
        params = {k: v for k, v in params.items() if trainable_mask.get(k)}
    return KerasAdam(params, train_config, grad_norm_sq)


def make_train_step(loss_fn: Callable, optimizer: KerasAdam,
                    with_rng: bool = False, layout=None):
    """``loss_fn(params, x, y, mask[, generator])`` -> scalar tensor.
    Returns ``step(params, x, y, mask[, generator[, scale]])``: one forward,
    backward and Adam update; returns the loss as a device tensor (no host
    read).  With a ``layout`` (:class:`_Layout`, whose optimizer
    ``optimizer`` is) the parameters come from it, the loss is multiplied
    by ``scale`` (this rank's share of the global batch) and the gradients
    and loss are reduced over the ranks before the update."""

    def step(params, x, y, mask, generator=None, scale=None):
        optimizer.zero_grad()
        if layout is not None:
            params = layout.forward_params()
        if with_rng:
            loss = loss_fn(params, x, y, mask, generator)
        else:
            loss = loss_fn(params, x, y, mask)
        if scale is not None:
            loss = loss * scale
        loss.backward()
        loss, grads = loss.detach(), None
        if layout is not None:
            grads, loss = layout.reduce_grads(loss)
        optimizer.step(grads)
        return loss

    return step


class _Layout:
    """Where a fit's parameters live on a mesh and how its gradients meet:
    replicated over ``dp`` (gradients summed), or FSDP (each rank holds its
    blocks of the sharded tensors and of their moments; parameters
    gathered before the forward, gradients reduce-scattered).  On a
    one-process mesh (``Mesh.local``) every collective returns its inputs
    and this is the plain fit."""

    def __init__(self, params, trains, train_config, mesh, fsdp, min_elems):
        self.mesh, self.trains = mesh, trains
        if fsdp:
            held, self.dims = fsdp_shard_params(params, mesh, min_elems)
        else:
            held = replicate_params(params, mesh)
            self.dims = {k: None for k in held}
        self.held = held
        self.sharded = sorted(k for k in held if self.dims[k] is not None)
        for k, v in held.items():
            # a block is updated from the reduce-scattered gradient, never
            # through autograd
            v.requires_grad_(trains[k] and self.dims[k] is None)
        self.optimizer = make_optimizer(
            train_config, held, trains,
            self._grad_norm_sq if self.sharded else None)
        self._full = None

    def _gather(self, blocks: dict) -> dict:
        """The whole tensors of the sharded ``blocks`` (name -> this rank's
        block): one gather over ``dp`` for all of them."""
        if not blocks:
            return {}
        names = sorted(blocks)
        flat = torch.cat([blocks[k].reshape(-1) for k in names])
        rows = self.mesh.gather(flat, "dp").view(self.mesh.n_dp, -1)
        out, at = {}, 0
        for k in names:
            n = blocks[k].numel()
            out[k] = torch.cat([rows[i, at:at + n].view(blocks[k].shape)
                                for i in range(self.mesh.n_dp)],
                               dim=self.dims[k])
            at += n
        return out

    def forward_params(self) -> dict:
        """The parameters the loss reads: the held ones, the sharded ones
        gathered whole (leaves that take a gradient where they train)."""
        if not self.sharded:
            return self.held
        full = self._gather({k: self.held[k] for k in self.sharded})
        for k, v in full.items():
            v.requires_grad_(self.trains[k])
        self._full = {**self.held, **full}
        return self._full

    def full_params(self) -> dict:
        """name -> whole tensor, detached (a collective under FSDP)."""
        full = self._gather({k: self.held[k] for k in self.sharded})
        return {k: full.get(k, v).detach() for k, v in self.held.items()}

    def reduce_grads(self, loss):
        """The optimizer's gradients (in its ``names`` order) and the
        global loss, after the backward: replicated gradients and the loss
        summed over ``dp`` in one collective, sharded ones reduce-scattered
        in another."""
        opt = self.optimizer
        params = self._full or self.held
        grads = {}
        for k in opt.names:
            g = params[k].grad
            grads[k] = g if g is not None else torch.zeros_like(params[k])
        rep = [k for k in opt.names if self.dims[k] is None]
        summed = self.mesh.reduce(*[grads[k] for k in rep], loss,
                                  axis="dp")
        out = dict(zip(rep, summed[:-1]))
        shard = [k for k in opt.names if self.dims[k] is not None]
        if shard:
            n = self.mesh.n_dp
            blocks = [[grads[k].chunk(n, dim=self.dims[k])[i].reshape(-1)
                       for k in shard] for i in range(n)]
            mine = self.mesh.reduce_scatter(
                torch.cat([torch.cat(b) for b in blocks]), "dp")
            at = 0
            for k in shard:
                out[k] = mine[at:at + self.held[k].numel()].view(
                    self.held[k].shape)
                at += self.held[k].numel()
        self._full = None
        return [out[k] for k in opt.names], summed[-1]

    def _grad_norm_sq(self, grads):
        opt = self.optimizer
        local = sum(torch.sum(g * g) for k, g in zip(opt.names, grads)
                    if self.dims[k] is not None)
        (local,) = self.mesh.reduce(local, axis="dp")
        return local + sum(torch.sum(g * g) for k, g in zip(opt.names, grads)
                           if self.dims[k] is None)

    def optimizer_state(self) -> dict:
        """``KerasAdam.state_dict()`` with whole moments (a collective
        under FSDP)."""
        opt = self.optimizer
        whole = {}
        for which in ("mu", "nu"):
            blocks = {k: m for k, m in zip(opt.names, getattr(opt, which))
                      if self.dims[k] is not None}
            full = self._gather(blocks)
            whole[which] = [full.get(k, m) for k, m in
                            zip(opt.names, getattr(opt, which))]
        return {"names": opt.names, "count": opt.count, **whole}

    @torch.no_grad()
    def load(self, state):
        """Whole parameters and moments from a resume state, each rank
        keeping its blocks."""
        opt = self.optimizer

        def block(k, v):
            t = torch.from_numpy(np.asarray(v))
            if self.dims[k] is not None:
                t = t.chunk(self.mesh.n_dp, dim=self.dims[k])[self.mesh.i_dp]
            return t

        for k, v in state["params"].items():
            self.held[k].copy_(block(k, v))
        for which in ("mu", "nu"):
            for k, t, v in zip(opt.names, getattr(opt, which),
                               state["opt"][which]):
                t.copy_(block(k, v))
        opt.count = int(state["opt"]["count"])

    def resident_bytes(self) -> dict:
        """Bytes this rank holds of parameters and of Adam moments."""
        opt = self.optimizer
        return {"params": sum(v.numel() * v.element_size()
                              for v in self.held.values()),
                "moments": sum(m.numel() * m.element_size()
                               for m in opt.mu + opt.nu)}


def _to_device(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.asarray(a)).to(device)


def evaluate(eval_fn: Callable, params: dict, data, batch_size=EVAL_BATCH,
             device="cuda", mesh=None) -> float:
    """Masked-mean loss over a whole split, without gradients, in batches of
    ``batch_size``, each weighted by its valid frames.  With ``mesh`` each
    rank takes its rows of each batch and the weighted sums are summed over
    ``dp``."""
    x, y, mask = data
    total, weight = 0.0, 0.0
    with torch.no_grad():
        for start in range(0, x.shape[0], batch_size):
            batch = shard_batch(tuple(a[start:start + batch_size]
                                      for a in (x, y, mask)), mesh)
            xb, yb, mb = (_to_device(a, device) for a in batch)
            w = float(_step_weights(mb).sum())
            total += float(eval_fn(params, xb, yb, mb)) * w
            weight += w
    if mesh is not None:
        total, weight = mesh.reduce(torch.tensor(
            [total, weight], dtype=torch.float64, device=device))[0].tolist()
    return total / max(weight, 1.0)


def _step_seed(seed: int, step: int) -> int:
    """The dropout generator's seed at a global step."""
    return (seed * 1_000_003 + step) % (1 << 63)


def _batch_source(data, device):
    """``fetch(idx)`` -> the batch's (x, y, mask) on ``device``: a gather on
    the device where the split was uploaded, else a host gather copied
    through pinned memory without blocking."""
    on_device = all(isinstance(a, torch.Tensor)
                    and a.device.type == device.type for a in data)
    if on_device:
        def fetch(idx):
            idx = torch.from_numpy(idx).to(device)
            return tuple(a[idx] for a in data)
    else:
        def fetch(idx):
            out = []
            for a in data:
                t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)[idx]))
                if device.type == "cuda":
                    t = t.pin_memory().to(device, non_blocking=True)
                out.append(t)
            return tuple(out)
    return fetch


def train_model(params: dict, loss_fn: Callable, train_data, valid_data,
                train_config: TrainConfig,
                trainable_mask: Optional[dict] = None,
                savefile: Optional[str] = None,
                histfile: Optional[str] = None,
                eval_loss_fn: Optional[Callable] = None,
                loss_takes_rng: bool = False, resume: bool = False,
                device="cuda", mesh=None, fsdp: bool = False,
                fsdp_min_elems: int = 1 << 16):
    """Fit with early stopping; returns (best_params, history).

    ``params``: name -> array or tensor (copied; the caller's stay as they
    are).  ``train_data`` / ``valid_data``: (x, y, mask) numpy arrays.
    ``loss_fn(params, x, y, mask[, generator])`` -> scalar tensor, with a
    ``torch.Generator`` when ``loss_takes_rng`` (dropout); validation uses
    ``eval_loss_fn`` (defaults to ``loss_fn``), always without one.
    ``trainable_mask``: name -> bool (all train when None).  ``resume``
    (with ``savefile``): keep the resume state and continue from it where
    it exists (module docstring).  Runs on the card unless
    ``device="cpu"``; raises when CUDA was asked for and is absent.
    ``mesh`` (a ``parallel.mesh.Mesh``; its device replaces ``device``):
    the fit on every rank, rows split over ``dp``; ``fsdp=True`` (needs
    ``mesh``) shards parameters and moments over ``dp``, tensors under
    ``fsdp_min_elems`` elements replicated (module docstring).
    ``best_params``: name -> numpy array, as the JAX loop returns them.
    ``history.layout``: the layout and the bytes this rank holds of
    parameters and Adam moments."""
    if fsdp and mesh is None:
        raise ValueError("fsdp=True requires a mesh")
    kind = "single" if mesh is None else "fsdp" if fsdp else "replicated"
    if mesh is None:
        mesh = Mesh.local(resolve_device(device))
    device = mesh.device
    trains = ({k: True for k in params} if trainable_mask is None
              else {k: bool(trainable_mask.get(k, True)) for k in params})

    def host(v):  # a copy: on the CPU .numpy() would alias the parameter
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy().copy()
        return np.array(v, np.float32)

    # frozen values from the caller, whole on every rank (never gathered)
    frozen_np = {k: host(v) for k, v in params.items() if not trains[k]}
    layout = _Layout(params, trains, train_config, mesh, fsdp, fsdp_min_elems)
    params, optimizer = layout.held, layout.optimizer
    rank0 = mesh.rank == 0
    step_fn = make_train_step(loss_fn, optimizer, with_rng=loss_takes_rng,
                              layout=layout)
    eval_fn = eval_loss_fn if eval_loss_fn is not None else loss_fn
    state_file = (savefile + ".train_state") if (resume and savefile) else None
    resuming = bool(state_file and os.path.exists(state_file))
    history = LossHistory(histfile if rank0 else None,
                          resume=resuming and rank0)
    history.layout = {"layout": kind, **layout.resident_bytes()}
    generator = torch.Generator(device=device) if loss_takes_rng else None
    global_step = 0

    n = train_data[0].shape[0]
    # the valid frames of each global batch, counted on the host
    frames = _step_weights(torch.as_tensor(np.asarray(train_data[2]))).sum(
        dim=1).double().numpy()
    nbytes = sum(np.asarray(a).nbytes for a in (*train_data, *valid_data))
    share = DEVICE_DATA_SHARE / mesh.ranks_per_device
    if nbytes <= share * free_bytes(device):
        train_data = tuple(_to_device(a, device) for a in train_data)
        valid_data = tuple(_to_device(a, device) for a in valid_data)
    fetch = _batch_source(train_data, device)
    rng = np.random.default_rng(train_config.seed)
    bsz = train_config.batch_size

    def snapshot(p):
        return {**frozen_np, **{k: host(v) for k, v in p.items()
                                if k not in frozen_np}}

    # the best parameters stay a copy on the device until a write needs
    # them on the host (DRNMF_STATE_EVERY)
    save_every = max(1, int(os.environ.get("DRNMF_STATE_EVERY", "1")))
    best_params = snapshot(layout.full_params())
    best_dirty = False
    best_val = np.inf
    wait = 0
    start_epoch = 0
    if resuming:
        state = _load_train_state(state_file, optimizer.names, frozen_np)
        layout.load(state)
        best_params = state["best_params"]
        best_val = state["best_val"]
        wait = state["wait"]
        global_step = state["global_step"]
        start_epoch = state["epoch"] + 1
        if state["finished"] or wait > train_config.patience:
            start_epoch = train_config.epochs  # it had stopped early
        # the batch orders of the epochs run, drawn and dropped
        for _ in range(start_epoch):
            rng.permutation(n)
        if train_config.verbose and rank0:
            print(f"resuming from epoch {start_epoch} "
                  f"(best val_loss {best_val:.6f})")

    def materialize():
        nonlocal best_params, best_dirty
        if best_dirty:
            best_params = snapshot(best_params)
            best_dirty = False
        return best_params

    def rank_batch(idx):
        """This rank's rows of the global batch ``idx``, the dropout
        generator (on more than one dp rank its ``BatchRows`` view, which
        the DR-NMF loss reads) and the loss scale (exactly 1 on one
        rank)."""
        start, stop, per = shard_rows(len(idx), mesh)
        batch = pad_block(fetch(idx[start:stop]), per)
        scale = _step_weights(batch[2]).sum().clamp(min=1.0) / max(
            float(frames[idx].sum()), 1.0)
        gen = (BatchRows(generator, len(idx), start)
               if loss_takes_rng and mesh.n_dp > 1 else generator)
        return batch, gen, scale

    n_batches = len(range(0, n, bsz))
    loss_buf = torch.zeros(max(n_batches, 1), device=device)

    for epoch in range(start_epoch, train_config.epochs):
        t0 = time.time()
        order = rng.permutation(n)
        batches = [order[s:s + bsz] for s in range(0, n, bsz)]
        upcoming = rank_batch(batches[0]) if batches else None
        for bi in range(n_batches):
            batch, gen, scale = upcoming
            if bi + 1 < n_batches:  # its copy runs during this step
                upcoming = rank_batch(batches[bi + 1])
            if loss_takes_rng:
                generator.manual_seed(_step_seed(train_config.seed,
                                                 global_step))
                loss = step_fn(params, *batch, gen, scale=scale)
            else:
                loss = step_fn(params, *batch, scale=scale)
            loss_buf[bi] = loss
            global_step += 1
        # one host read for the epoch's per-batch losses
        batch_losses = loss_buf[:n_batches].cpu().numpy()
        epoch_loss = 0.0  # summed in order, as the JAX loop does
        for bl in batch_losses:
            history.on_batch_end({"loss": float(bl)})
            epoch_loss += float(bl)

        current = layout.full_params()
        val_loss = evaluate(eval_fn, current, valid_data, device=device,
                            mesh=mesh)
        history.on_epoch_end({"loss": epoch_loss / max(n_batches, 1),
                              "val_loss": val_loss})
        if train_config.verbose and rank0:
            print(f"epoch {epoch + 1}/{train_config.epochs}: "
                  f"loss {epoch_loss / max(n_batches, 1):.6f} "
                  f"val_loss {val_loss:.6f} ({time.time() - t0:.1f}s)")

        if val_loss < best_val:
            best_val = val_loss
            best_params = {k: v.detach().clone() for k, v in current.items()
                           if k not in frozen_np}
            best_dirty = True
            wait = 0
        else:
            wait += 1
        del current

        stopping = wait > train_config.patience
        deadline = float(os.environ.get("DRNMF_TRAIN_DEADLINE_TS", "0"))
        deadline_hit = bool(state_file and deadline and time.time() > deadline
                            and epoch + 1 < train_config.epochs)
        if mesh.world > 1:  # every rank stops where rank 0's clock says
            deadline_hit = bool(mesh.broadcast(torch.tensor(
                [float(deadline_hit)], device=device)).item())
        if (stopping or deadline_hit or (epoch + 1) % save_every == 0
                or epoch + 1 == train_config.epochs):
            if best_dirty:
                materialize()
                if savefile is not None and rank0:
                    save_checkpoint(savefile, best_params,
                                    meta={"val_loss": best_val})
            if state_file:
                # 'finished' marks an early stop only: a fit that reached
                # its epochs may be extended by resuming with more
                whole = layout.full_params()
                opt = layout.optimizer_state()
                if rank0:
                    _save_train_state(state_file, epoch, whole, opt,
                                      best_params, best_val, wait,
                                      global_step, frozen_np,
                                      finished=stopping)
            mesh.barrier()  # rank 0's files are there for every rank
        if stopping:
            if train_config.verbose and rank0:
                print(f"early stopping at epoch {epoch + 1}")
            break
        if deadline_hit:
            raise TrainingDeadline(
                f"training deadline passed at epoch {epoch + 1}/"
                f"{train_config.epochs}; state saved -- resume to continue")

    if train_config.epochs == 0 and savefile is not None and rank0:
        # the reference's quirk, kept: epochs=0 writes the initial values
        save_checkpoint(savefile, best_params, meta={"val_loss": np.inf})
    mesh.barrier()
    return materialize(), history

