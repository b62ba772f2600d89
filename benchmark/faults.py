"""Faults planted in the program for the control runs and the tests: each
is a context manager that breaks the timed path underneath the harness, so
a run can show that its comparison catches it.  By cell kind (the
traffic's ``kind`` and the configuration's ``family``):

- ``state_unchanged``: a step that returns its state unchanged (Adam's
  update; the recurrence's state; the MU update of the activations);
- ``half_batch``: half of the batch left out (the loss's mean over the
  first half of the rows; the second half of each call's answers left
  empty);
- ``answer_altered``: an answer altered where it is produced (the ratio
  mask, one part in a thousand).

One card runs every cell, so no cell has an exchange between chips to
leave out."""

import contextlib


@contextlib.contextmanager
def patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _train_state_unchanged():
    from drnmf_torch.train import loop
    return patched(loop.KerasAdam, "step",
                   lambda orig: lambda self, grads=None: None)


def _train_half_batch():
    from drnmf_torch.train import losses

    def make(orig):
        def loss(irm, x, y, mask):
            h = x.shape[0] // 2
            return orig(irm[:h], x[:h], y[:h], mask[:h])
        return loss
    return patched(losses, "masked_mse_signal_approx", make)


def _drnmf_state_unchanged():
    from drnmf_torch.models import drnmf

    def make(orig):
        def scan(x, step_mask, h0, *weights):
            return h0[:, None, :].expand(x.shape[0], x.shape[1],
                                         h0.shape[1]).contiguous()
        return scan
    return patched(drnmf, "drnmf_scan_factored", make)


def _drnmf_half_batch():
    from drnmf_torch import enhance

    def make(orig):
        def enhance_signals(params, config, signals, *args, **kwargs):
            out = orig(params, config, signals, *args, **kwargs)
            half = len(out) // 2
            return out[:half] + [o * 0.0 for o in out[half:]]
        return enhance_signals
    return patched(enhance, "enhance_signals", make)


def _drnmf_answer_altered():
    from drnmf_torch import enhance
    return patched(enhance, "drnmf_forward",
                   lambda orig: lambda *a, **k: orig(*a, **k) * 1.001)


def _snmf_state_unchanged():
    from drnmf_torch.ops import snmf_mu

    def make(orig):
        def iteration(v, h, *args):
            _, w, div, cost = orig(v, h, *args)
            return h, w, div, cost
        return iteration
    return patched(snmf_mu, "mu_ed_iteration", make)


def _snmf_irm(change):
    from drnmf_torch.models import snmf_enhancer

    def make(orig):
        def infer(*args, **kwargs):
            irm, h = orig(*args, **kwargs)
            return change(irm), h
        return infer
    return patched(snmf_enhancer, "snmf_infer_irm", make)


def _snmf_half_batch():
    def change(irm):
        irm = irm.copy()
        irm[:, irm.shape[1] // 2:] = 0.0
        return irm
    return _snmf_irm(change)


FAULTS = {
    ("train", "drnmf"): {"state_unchanged": _train_state_unchanged,
                         "half_batch": _train_half_batch},
    ("offline", "drnmf"): {"state_unchanged": _drnmf_state_unchanged,
                           "half_batch": _drnmf_half_batch,
                           "answer_altered": _drnmf_answer_altered},
    ("offline", "snmf"): {"state_unchanged": _snmf_state_unchanged,
                          "half_batch": _snmf_half_batch,
                          "answer_altered": lambda: _snmf_irm(
                              lambda irm: irm * 1.001)},
}
