"""Results reporting: score tables and learning curves (counterpart of
``drnmf_tpu/reporting.py``; numpy over the files the pipeline writes).

Equivalent of the reference's print_scores.py (LaTeX table rows of model,
depth, hidden size, trainable parameter count, best val loss, mean SDR per
dataset) and the learning-curve notebook.
"""

import os
import pickle

import numpy as np

from .train.checkpoint import load_checkpoint
from .train.history import LossHistory


def count_trainable_params(checkpoint_path, trainable_keys=None):
    """Trainable-parameter count from a checkpoint (print_scores.py:36-56
    counted HDF5 weights filtered by params_trainable)."""
    params, _ = load_checkpoint(checkpoint_path)
    total = 0
    for k, v in params.items():
        if trainable_keys is None or any(k.startswith(t) for t in trainable_keys):
            total += int(np.prod(np.shape(v)))
    return total


def best_val_loss(histfile):
    hist = LossHistory.load(histfile)
    return float(np.min(hist["on_epoch_end"]["val_loss"]))


def mean_scores_from_files(score_files, score_idx=0):
    """Mean of a score column over several per-SNR .npz score files."""
    total, count = 0.0, 0
    for path in score_files:
        data = np.load(path)
        S = data["S"]
        total += float(np.sum(S[:, score_idx]))
        count += S.shape[0]
    return total / max(count, 1)


def latex_table(rows, labels=("Model", "K", "N", "Params", "val loss", "SDR")):
    """rows: list of tuples -> LaTeX tabular body (print_scores.py style)."""
    lines = [" & ".join(str(label) for label in labels) + r" \\ \hline"]
    for row in rows:
        cells = [
            f"{c:.3f}" if isinstance(c, float) else str(c) for c in row
        ]
        lines.append(" & ".join(cells) + r" \\")
    return "\n".join(lines)


def learning_curve(histfile, iterations_per_epoch=None):
    """(iterations, val_losses) for plotting (the notebook's data prep)."""
    hist = LossHistory.load(histfile)
    vals = np.asarray(hist["on_epoch_end"]["val_loss"])
    if iterations_per_epoch is None:
        n_batches = len(hist["on_batch_end"].get("loss", []))
        iterations_per_epoch = max(1, n_batches // max(1, len(vals)))
    iters = np.arange(1, len(vals) + 1) * iterations_per_epoch
    return iters, vals


def summarize_experiment(folder_exp):
    """Collect every trained model's history + scores in a folder."""
    rows = []
    hist_dir = os.path.join(folder_exp, "history")
    if not os.path.isdir(hist_dir):
        return rows
    for fname in sorted(os.listdir(hist_dir)):
        if fname.endswith("_pretrain"):
            continue
        histfile = os.path.join(hist_dir, fname)
        try:
            vloss = best_val_loss(histfile)
        except (OSError, EOFError, KeyError, ValueError,
                pickle.UnpicklingError):
            continue  # not a history file
        tag = fname.replace("history_", "")
        score_dir = os.path.join(folder_exp, "scores")
        sdrs = []
        if os.path.isdir(score_dir):
            files = [
                os.path.join(score_dir, s)
                for s in os.listdir(score_dir)
                if tag in s and s.endswith(".npz")
            ]
            if files:
                sdrs = [mean_scores_from_files(files, score_idx=0)]
        rows.append({"model": tag, "val_loss": vloss,
                     "mean_sdr": sdrs[0] if sdrs else None})
    return rows
