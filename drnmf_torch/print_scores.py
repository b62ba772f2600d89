"""Score table: model, depth, hidden size, trainable params, best val loss,
mean SDR per split -- as plain text or LaTeX rows (counterpart of
``scripts/print_scores.py``).

Equivalent of the reference's print_scores.py:1-322 (which assembled LaTeX
table rows from HDF5 weight files, pickled histories, and MATLAB .mat score
files); here the sources are the npz checkpoints, pickled histories, and npz
score files the pipeline writes.

Usage:
    python -m drnmf_torch.print_scores data_setup_downsample1 [--latex] [--per-snr]
    python -m drnmf_torch.print_scores data_setup_downsample1 data_setup_downsample10

``--per-snr`` adds the per-SNR-condition breakdown (m6dB..9dB columns per
split) like the reference's ``print_per_snr`` mode (print_scores.py:93-100).
Passing SEVERAL experiment dirs prints ONE combined table with a per-row
num_train column -- the paper's both-data-conditions layout (the reference
assembled 100%% and 10%% rows into one LaTeX table, print_scores.py:34).
"""

import argparse
import os
import sys

import numpy as np
import yaml

from .reporting import (best_val_loss, count_trainable_params, latex_table,
                        mean_scores_from_files)


SNRS = ["m6dB", "m3dB", "0dB", "3dB", "6dB", "9dB"]


def per_snr_means(folder_exp, tag, split, score_idx=0):
    """Mean score per SNR condition for one model+split, from the per-SNR
    score files the pipeline writes (scores_<tag>_<split>_<snr>.npz).
    Returns {snr: mean} for the conditions that have a score file."""
    score_dir = os.path.join(folder_exp, "scores")
    out = {}
    for snr in SNRS:
        path = os.path.join(score_dir, f"scores_{tag}_{split}_{snr}.npz")
        if os.path.isfile(path):
            S = np.load(path)["S"]
            out[snr] = float(np.mean(S[:, score_idx]))
    return out


def model_rows(folder_exp, splits=("valid", "test")):
    cfg_dir = os.path.join(folder_exp, "configs")
    rows = []
    if not os.path.isdir(cfg_dir):
        return rows
    for fname in sorted(os.listdir(cfg_dir)):
        if not fname.endswith(".yaml"):
            continue
        tag = fname[len("params_"):-len(".yaml")]  # e.g. unfolded_snmf_<hash>
        with open(os.path.join(cfg_dir, fname)) as f:
            cfg = yaml.safe_load(f)
        model_type = tag.rsplit("_", 1)[0]
        K = cfg.get("K_layers", "-")
        hidden = cfg.get("hidden_dim", 2 * cfg.get("r", 0) or "-")

        ckpt = os.path.join(folder_exp, "models", f"model_{tag}.npz")
        n_params = "-"
        if os.path.isfile(ckpt):
            trainable = cfg.get("params_trainable")
            keys = None
            if trainable:
                # untied params are stored as <name>_<k>; the prefix match
                # inside count_trainable_params covers tied and untied alike
                keys = list(trainable) + [
                    "log_h0", "h0", "log_W_clean", "log_W_noise"
                ]
            n_params = count_trainable_params(ckpt, trainable_keys=keys)

        histfile = os.path.join(folder_exp, "history", f"history_{tag}")
        vloss = None
        if os.path.isfile(histfile):
            try:
                vloss = best_val_loss(histfile)
            except Exception:
                pass

        sdrs = {}
        score_dir = os.path.join(folder_exp, "scores")
        for split in splits:
            if not os.path.isdir(score_dir):
                continue
            files = [
                os.path.join(score_dir, s) for s in os.listdir(score_dir)
                if tag in s and f"_{split}_" in s and s.endswith(".npz")
            ]
            if files:
                sdrs[split] = mean_scores_from_files(files, score_idx=0)

        rows.append({
            "model": model_type, "tag": tag, "K": K, "N": hidden,
            "params": n_params, "val_loss": vloss,
            **{f"sdr_{s}": sdrs.get(s) for s in splits},
        })
    return rows


def num_train_files(data_cfg):
    """Training files actually used: taskfile length under the downsample
    stride (reference print_scores.py:34's num_train column -- the 10%%-
    vs-100%%-data conditions differ exactly here)."""
    tf = data_cfg.get("taskfile_x_train")
    ds = int(data_cfg.get("downsample", 1))
    if tf and os.path.isfile(tf):
        with open(tf) as f:
            n = sum(1 for line in f if line.strip())
        return len(range(0, n, ds))
    return None


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("folder_exp", nargs="+")
    parser.add_argument("--latex", action="store_true")
    parser.add_argument("--splits", default="valid,test")
    parser.add_argument("--data-config", default=None,
                        help="params_data.yaml for the num_train column "
                        "(default: <folder_exp>/params_data.yaml if present)")
    parser.add_argument("--per-snr", action="store_true",
                        help="add mean-SDR-per-SNR-condition columns "
                        "(reference print_scores.py:93-100)")
    args = parser.parse_args(argv)

    splits = tuple(s for s in args.splits.split(",") if s)
    rows, n_train = [], None
    for folder in args.folder_exp:
        frows = model_rows(folder, splits)
        if not frows:
            sys.exit(f"no configs found under {folder}/configs")
        data_cfg_path = (args.data_config if len(args.folder_exp) == 1
                         and args.data_config
                         else os.path.join(folder, "params_data.yaml"))
        nt = None
        if os.path.isfile(data_cfg_path):
            with open(data_cfg_path) as f:
                nt = num_train_files(yaml.safe_load(f))
        for r in frows:
            r["num_train"] = nt
            r["folder"] = folder
        n_train = nt if nt is not None else n_train
        rows.extend(frows)
    if len(args.folder_exp) > 1:
        # both-conditions layout: pair each model's conditions, full data
        # first (reference print_scores.py:34 num_train ordering); size
        # keys sort numerically ('-' placeholders last)
        def _num(v):
            return (0, v) if isinstance(v, int) else (1, 0)

        rows.sort(key=lambda r: (r["model"], _num(r["N"]), _num(r["K"]),
                                 -(r["num_train"] or 0)))

    def fmt(v, spec=".3f"):
        return format(v, spec) if isinstance(v, float) else str(v)

    if args.per_snr:
        # per-SNR breakdown: one row per model, SNR-condition columns per
        # split, then the overall mean (reference print_per_snr layout)
        for split in splits:
            print(f"mean SDR per SNR -- {split}:")
            hdr = (f"{'model':<36} "
                   + " ".join(f"{snr:>7}" for snr in SNRS) + f" {'all':>7}")
            print(hdr)
            print("-" * len(hdr))
            for r in rows:
                means = per_snr_means(r["folder"], r["tag"], split)
                if not means:
                    continue
                cols = " ".join(
                    f"{means[snr]:7.2f}" if snr in means else f"{'-':>7}"
                    for snr in SNRS
                )
                overall = r.get(f"sdr_{split}")
                ov = f"{overall:7.2f}" if overall is not None else f"{'-':>7}"
                print(f"{r['tag']:<36} {cols} {ov}")
            print()
        return

    multi = len(args.folder_exp) > 1
    if args.latex:
        nt_lab = ("num train",) if multi else ()
        table_rows = [
            (r["model"], r["K"], r["N"], r["params"],
             *((r["num_train"] if r["num_train"] is not None else "-",)
               if multi else ()),
             r["val_loss"] if r["val_loss"] is not None else "-",
             *[r[f"sdr_{s}"] if r[f"sdr_{s}"] is not None else "-"
               for s in splits])
            for r in rows
        ]
        labels = ("Model", "K", "N", "Params", *nt_lab, "val loss",
                  *[f"SDR {s}" for s in splits])
        print(latex_table(table_rows, labels))
        return

    show_nt = multi or n_train is not None
    nt_col = f" {'num_train':>9}" if show_nt else ""
    hdr = (f"{'model':<16} {'K':>2} {'N':>5} {'params':>9}{nt_col} "
           f"{'val_loss':>10} "
           + " ".join(f"{'SDR ' + s:>10}" for s in splits))
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        vl = fmt(r["val_loss"], ".5f") if r["val_loss"] is not None else "-"
        sdr_cols = " ".join(
            f"{fmt(r[f'sdr_{s}'], '.2f') if r[f'sdr_{s}'] is not None else '-':>10}"
            for s in splits
        )
        rnt = r["num_train"] if multi else n_train
        nt = f" {rnt if rnt is not None else '-':>9}" if show_nt else ""
        print(f"{r['model']:<16} {r['K']:>2} {r['N']:>5} {r['params']:>9}"
              f"{nt} {vl:>10} {sdr_cols}")


if __name__ == "__main__":
    main(sys.argv[1:])
