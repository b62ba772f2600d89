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

Not ported: the mesh and FSDP arguments (ROADMAP.md queue A, item 10), and
XLA's devices (buffer donation, ``make_epoch_chunk``,
``DRNMF_EPOCH_FUSE*``).
"""

import os
import pickle
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..device import free_bytes, params_on_device, resolve_device
from .checkpoint import save_checkpoint
from .history import LossHistory

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


def _save_train_state(path, epoch, params, optimizer, best_params, best_val,
                      wait, global_step, frozen, finished=False):
    """The whole training state, written to a temporary file and renamed.
    ``frozen``: name -> host array of the frozen parameters, stored only as
    fingerprints."""

    def host(v):
        return v.detach().cpu().numpy().copy()

    state = {
        "epoch": epoch,
        "params": {k: host(v) for k, v in params.items() if k not in frozen},
        "opt": {"names": list(optimizer.names), "count": optimizer.count,
                "mu": [host(m) for m in optimizer.mu],
                "nu": [host(m) for m in optimizer.nu]},
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


def _load_train_state(path, params, optimizer, frozen):
    """Restore the trainable parameters and the optimizer in place from
    ``path``; returns the state dict with the best parameters completed by
    ``frozen`` (the caller's frozen values, checked by fingerprint)."""
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
    if state["opt"]["names"] != optimizer.names:
        raise ValueError(f"train state {path} trains "
                         f"{state['opt']['names']}, this fit "
                         f"{optimizer.names}")
    with torch.no_grad():
        for k, v in state["params"].items():
            params[k].copy_(torch.from_numpy(v))
        for dst, src in ((optimizer.mu, state["opt"]["mu"]),
                         (optimizer.nu, state["opt"]["nu"])):
            for t, v in zip(dst, src):
                t.copy_(torch.from_numpy(v))
    optimizer.count = int(state["opt"]["count"])
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
    the device: no host synchronisation a step."""

    def __init__(self, params: dict, train_config: TrainConfig):
        self.names = sorted(params)
        self.params = [params[k] for k in self.names]
        self.lr = float(train_config.learning_rate)
        self.decay = float(train_config.decay)
        self.clipnorm = float(train_config.clipnorm or 0.0)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.clipnorm > 0:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
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
                   trainable_mask: Optional[dict] = None) -> KerasAdam:
    """Keras-Adam over the trainable entries of ``params`` (name -> leaf
    tensor); the frozen ones are left out and never written."""
    if trainable_mask is not None:
        params = {k: v for k, v in params.items() if trainable_mask.get(k)}
    return KerasAdam(params, train_config)


def make_train_step(loss_fn: Callable, optimizer: KerasAdam,
                    with_rng: bool = False):
    """``loss_fn(params, x, y, mask[, generator])`` -> scalar tensor.
    Returns ``step(params, x, y, mask[, generator])``: one forward, backward
    and Adam update; returns the loss as a device tensor (no host read)."""

    def step(params, x, y, mask, generator=None):
        optimizer.zero_grad()
        if with_rng:
            loss = loss_fn(params, x, y, mask, generator)
        else:
            loss = loss_fn(params, x, y, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def _to_device(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.asarray(a)).to(device)


def evaluate(eval_fn: Callable, params: dict, data, batch_size=EVAL_BATCH,
             device="cuda") -> float:
    """Masked-mean loss over a whole split, without gradients, in batches of
    ``batch_size``, each weighted by its valid frames."""
    x, y, mask = data
    total, weight = 0.0, 0.0
    with torch.no_grad():
        for start in range(0, x.shape[0], batch_size):
            xb, yb, mb = (_to_device(a[start:start + batch_size], device)
                          for a in (x, y, mask))
            w = float((mb[..., 0] if mb.dim() == 3 else mb).sum())
            total += float(eval_fn(params, xb, yb, mb)) * w
            weight += w
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
                device="cuda"):
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
    ``best_params``: name -> numpy array, as the JAX loop returns them."""
    device = resolve_device(device)
    params = {k: v.clone() for k, v in params_on_device(params, device)
              .items()}
    trains = ({k: True for k in params} if trainable_mask is None
              else {k: bool(trainable_mask.get(k, True)) for k in params})
    for k, v in params.items():
        v.requires_grad_(trains[k])
    optimizer = make_optimizer(train_config, params, trains)
    step_fn = make_train_step(loss_fn, optimizer, with_rng=loss_takes_rng)
    eval_fn = eval_loss_fn if eval_loss_fn is not None else loss_fn
    state_file = (savefile + ".train_state") if (resume and savefile) else None
    resuming = bool(state_file and os.path.exists(state_file))
    history = LossHistory(histfile, resume=resuming)
    generator = torch.Generator(device=device) if loss_takes_rng else None
    global_step = 0

    n = train_data[0].shape[0]
    nbytes = sum(np.asarray(a).nbytes for a in (*train_data, *valid_data))
    if nbytes <= DEVICE_DATA_SHARE * free_bytes(device):
        train_data = tuple(_to_device(a, device) for a in train_data)
        valid_data = tuple(_to_device(a, device) for a in valid_data)
    fetch = _batch_source(train_data, device)
    rng = np.random.default_rng(train_config.seed)
    bsz = train_config.batch_size

    def host(v):  # a copy: on the CPU .numpy() would alias the parameter
        return v.detach().cpu().numpy().copy()

    frozen_np = {k: host(v) for k, v in params.items() if not trains[k]}

    def snapshot(p):
        return {**frozen_np, **{k: host(v) for k, v in p.items()
                                if k not in frozen_np}}

    # the best parameters stay a copy on the device until a write needs
    # them on the host (DRNMF_STATE_EVERY)
    save_every = max(1, int(os.environ.get("DRNMF_STATE_EVERY", "1")))
    best_params = snapshot(params)
    best_dirty = False
    best_val = np.inf
    wait = 0
    start_epoch = 0
    if resuming:
        state = _load_train_state(state_file, params, optimizer, frozen_np)
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
        if train_config.verbose:
            print(f"resuming from epoch {start_epoch} "
                  f"(best val_loss {best_val:.6f})")

    def materialize():
        nonlocal best_params, best_dirty
        if best_dirty:
            best_params = snapshot(best_params)
            best_dirty = False
        return best_params

    n_batches = len(range(0, n, bsz))
    loss_buf = torch.zeros(max(n_batches, 1), device=device)

    for epoch in range(start_epoch, train_config.epochs):
        t0 = time.time()
        order = rng.permutation(n)
        batches = [order[s:s + bsz] for s in range(0, n, bsz)]
        upcoming = fetch(batches[0]) if batches else None
        for bi in range(n_batches):
            batch = upcoming
            if bi + 1 < n_batches:  # its copy runs during this step
                upcoming = fetch(batches[bi + 1])
            if loss_takes_rng:
                generator.manual_seed(_step_seed(train_config.seed,
                                                 global_step))
                loss = step_fn(params, *batch, generator)
            else:
                loss = step_fn(params, *batch)
            loss_buf[bi] = loss
            global_step += 1
        # one host read for the epoch's per-batch losses
        batch_losses = loss_buf[:n_batches].cpu().numpy()
        epoch_loss = 0.0  # summed in order, as the JAX loop does
        for bl in batch_losses:
            history.on_batch_end({"loss": float(bl)})
            epoch_loss += float(bl)

        val_loss = evaluate(eval_fn, params, valid_data, device=device)
        history.on_epoch_end({"loss": epoch_loss / max(n_batches, 1),
                              "val_loss": val_loss})
        if train_config.verbose:
            print(f"epoch {epoch + 1}/{train_config.epochs}: "
                  f"loss {epoch_loss / max(n_batches, 1):.6f} "
                  f"val_loss {val_loss:.6f} ({time.time() - t0:.1f}s)")

        if val_loss < best_val:
            best_val = val_loss
            best_params = {k: v.detach().clone() for k, v in params.items()
                           if k not in frozen_np}
            best_dirty = True
            wait = 0
        else:
            wait += 1

        stopping = wait > train_config.patience
        deadline = float(os.environ.get("DRNMF_TRAIN_DEADLINE_TS", "0"))
        deadline_hit = bool(state_file and deadline and time.time() > deadline
                            and epoch + 1 < train_config.epochs)
        if (stopping or deadline_hit or (epoch + 1) % save_every == 0
                or epoch + 1 == train_config.epochs):
            if best_dirty:
                materialize()
                if savefile is not None:
                    save_checkpoint(savefile, best_params,
                                    meta={"val_loss": best_val})
            if state_file:
                # 'finished' marks an early stop only: a fit that reached
                # its epochs may be extended by resuming with more
                _save_train_state(state_file, epoch, params, optimizer,
                                  best_params, best_val, wait, global_step,
                                  frozen_np, finished=stopping)
        if stopping:
            if train_config.verbose:
                print(f"early stopping at epoch {epoch + 1}")
            break
        if deadline_hit:
            raise TrainingDeadline(
                f"training deadline passed at epoch {epoch + 1}/"
                f"{train_config.epochs}; state saved -- resume to continue")

    if train_config.epochs == 0 and savefile is not None:
        # the reference's quirk, kept: epochs=0 writes the initial values
        save_checkpoint(savefile, best_params, meta={"val_loss": np.inf})
    return materialize(), history
