"""Training metric history (counterpart of ``drnmf_tpu/train/history.py``).

``LossHistory`` records every batch-end and epoch-end metric dict and
pickles the whole history to the histfile after each epoch, as
``{'on_batch_end': {...}, 'on_epoch_end': {...}}`` with a list of floats a
metric: the layout the JAX package writes and its reporting reads.
"""

import os
import pickle


class LossHistory:
    def __init__(self, histfile=None, resume=False):
        self.histfile = histfile
        self.history = {"on_batch_end": {}, "on_epoch_end": {}}
        if resume and histfile is not None and os.path.exists(histfile):
            self.history = self.load(histfile)

    def _append(self, where, metrics):
        store = self.history[where]
        for key, value in metrics.items():
            store.setdefault(key, []).append(float(value))

    def on_batch_end(self, metrics):
        self._append("on_batch_end", metrics)

    def on_epoch_end(self, metrics):
        self._append("on_epoch_end", metrics)
        if self.histfile is not None:
            with open(self.histfile, "wb") as f:
                pickle.dump(self.history, f)

    @staticmethod
    def load(histfile):
        with open(histfile, "rb") as f:
            return pickle.load(f)
