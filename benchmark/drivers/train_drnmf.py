"""DR-NMF training steps at the reference schedule: the step that
``drnmf_torch.train.train_model`` composes on one process (its
``_Layout`` on ``Mesh.local``, ``make_train_step`` over ``KerasAdam``, the
pipeline's signal-approximation loss, a batch gathered from the split
held on the device, the batch's loss scale), over an epoch's split made
on the device.  The recurrence with gradients runs B1 with every layer
kept, the backward kernel and the weight-gradient products
(``models.batched_grad.scan_factored_train``).

Set-up builds the step once and drives it through its first
``checked_steps`` batches, which are the warm-up and what the reference
follows; the window then carries on with the same object."""

import statistics

import numpy as np
import torch

from drnmf_torch.models.drnmf import drnmf_forward, drnmf_trainable_mask
from drnmf_torch.parallel.mesh import Mesh
from drnmf_torch.train import loop, losses

from ..reference import drnmf as ref_drnmf
from ..yardstick.bounds import train_bounds, train_model_flops
from ..yardstick.compare import rel_gap
from ..yardstick.corpus import train_split
from .offline_drnmf import model

FAMILY = "drnmf"
RATE = "train_frames_per_s"
# leaves whose reference gradient is under this share of the median
# leaf's move by round-off alone under Adam: left out of the change
ROUND_OFF_SHARE = 1e-3


def loss_fn(cfg):
    """The pipeline's DR-NMF loss (pipeline.py:423-425)."""
    def fn(p, x, y, mask):
        return losses.masked_mse_signal_approx(drnmf_forward(p, cfg, x), x,
                                               y, mask)
    return fn


class Driver:
    def __init__(self, config, traffic, seed, device, trace):
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        self.config = config
        self.cfg, params, self.w, self.u_h0 = model(config, self.rng,
                                                    self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            int(self.rng.integers(2 ** 62)))
        self.x, self.y, self.mask, self.valid = train_split(
            traffic, config["n_fft"], config["hop"], config["fs"],
            config["mask_value"], self.rng, gen, self.device)
        self.bsz = int(traffic["batch"])
        self.n = self.x.shape[0]
        self.n_batches = -(-self.n // self.bsz)

        trains = drnmf_trainable_mask(self.cfg, params)
        self.trainable = sorted(k for k, t in trains.items() if t)
        tc = loop.TrainConfig(batch_size=self.bsz,
                              learning_rate=float(config["learning_rate"]),
                              clipnorm=float(config["clipnorm"]),
                              verbose=False)
        self.layout = loop._Layout(params, trains, tc,
                                   Mesh.local(self.device), False, 1 << 16)
        self.step_fn = loop.make_train_step(loss_fn(self.cfg),
                                            self.layout.optimizer,
                                            layout=self.layout)
        self.loss_buf = torch.zeros(self.n_batches, device=self.device)
        self._new_epoch()
        self.counters = {"steps": 0, "model_flops": 0.0,
                         "forward_bound_s": 0.0, "backward_bound_s": 0.0}

        # the checked steps: the warm-up, and what the reference follows
        opt = self.layout.optimizer
        held = self.layout.held
        start = {k: held[k].detach().clone() for k in self.trainable}
        self.checked = [self.batches[i]
                        for i in range(int(traffic["checked_steps"]))]
        self.checked_data = [tuple(a[torch.from_numpy(idx).to(self.device)]
                                   for a in (self.x, self.y, self.mask))
                             for idx in self.checked]
        got = []
        for i in range(len(self.checked)):
            got.append(self._step())
            if i == 0:  # the first gradient, from Adam's first moment
                self.first_grad = {
                    k: float((m / (1.0 - opt.b1)).norm())
                    for k, m in zip(opt.names, opt.mu)}
        self.losses = [float(v) for v in got]
        self.change = {k: float((held[k].detach() - start[k]).norm())
                       for k in self.trainable}
        self.counters.update(steps=0, model_flops=0.0, forward_bound_s=0.0,
                             backward_bound_s=0.0)

    def _new_epoch(self):
        order = self.rng.permutation(self.n)
        self.batches = [order[s:s + self.bsz]
                        for s in range(0, self.n, self.bsz)]
        self.at = 0

    def _step(self):
        """One step of ``train_model``'s loop on the next batch of the
        epoch; at the epoch's end its losses are read, as there."""
        if self.at == self.n_batches:
            self.loss_buf.cpu()
            self._new_epoch()
        idx = self.batches[self.at]
        batch = tuple(a[torch.from_numpy(idx).to(self.device)]
                      for a in (self.x, self.y, self.mask))
        valid = float(self.valid[idx].sum())
        scale = loop._step_weights(batch[2]).sum().clamp(min=1.0) / max(
            valid, 1.0)
        loss = self.step_fn(self.layout.held, *batch, scale=scale)
        self.loss_buf[self.at] = loss
        self.at += 1
        parts = train_bounds(len(idx), self.x.shape[1], self.x.shape[2],
                             self.cfg.hidden_dim, self.cfg.K_layers,
                             int(valid), sum(self.layout.held[k].numel()
                                             for k in self.trainable))
        cn = self.counters
        cn["steps"] += 1
        cn["model_flops"] += train_model_flops(parts)
        cn["forward_bound_s"] += parts["forward"]["bound_s"]
        cn["backward_bound_s"] += parts["backward"]["bound_s"]
        self.last_valid = valid
        return loss

    def call(self, i):
        self._step()
        return self.last_valid

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self):
        self.layout = self.step_fn = self.x = self.y = self.mask = None
        self.loss_buf = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_answers(self, precision="f32"):
        """The reference's (losses, first gradient norms, change norms) over
        the checked steps' batches."""
        params = ref_drnmf.init_params(self.config, self.w, self.u_h0)
        return ref_drnmf.train_steps(params, self.trainable, self.config,
                                     self.checked_data,
                                     float(self.config["learning_rate"]),
                                     precision)

    def answers(self):
        """The program's (losses, first gradient norms, change norms)."""
        return self.losses, self.first_grad, self.change

    def check(self, precision="f32"):
        self.release()
        return compare(self.answers(), self.reference_answers(precision))


def compare(got, want):
    """``loss_gap``: the widest relative gap of a checked step's loss;
    ``grad_gap``: of a leaf's first-gradient norm, against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger; ``change_gap``: the same of the norm of a leaf's change over
    the checked steps, leaving out the leaves whose reference gradient is
    under ``ROUND_OFF_SHARE`` of the median leaf's."""
    losses_g, grad_g, change_g = got
    losses_w, grad_w, change_w = want
    med_grad = statistics.median(grad_w.values())
    moved = [k for k in grad_w if grad_w[k] >= ROUND_OFF_SHARE * med_grad]
    med_change = statistics.median(change_w[k] for k in moved)
    return {
        "loss_gap": max(rel_gap(a, b, 0.0) for a, b in zip(losses_g,
                                                          losses_w)),
        "grad_gap": max(rel_gap(grad_g[k], grad_w[k], med_grad)
                        for k in grad_w),
        "change_gap": max(rel_gap(change_g[k], change_w[k], med_change)
                          for k in moved),
    }
