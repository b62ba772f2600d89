"""Plot validation-loss learning curves per experiment folder (counterpart
of ``scripts/plot_learning_curves.py``).

Equivalent of the reference's plot_learning_curves_waspaa2017.ipynb:
val-loss vs training iterations for every trained model in a
data_setup_downsample<d> folder.  Uses matplotlib where it is installed
(imported here, not before); without it, prints the curve data as text.

Usage:
    python -m drnmf_torch.plot_learning_curves data_setup_downsample1 \\
        [--iterations-per-epoch N] [--out curves.png]

``--iterations-per-epoch`` is the training steps of one epoch: a CHiME2
epoch (16,951 sequences of 500 frames) is 530 steps at batch 32.
"""

import argparse
import os
import sys

from .reporting import learning_curve


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("folder_exp")
    parser.add_argument("--iterations-per-epoch", type=int, default=None,
                        help="scale epochs to iterations (training steps "
                        "an epoch)")
    parser.add_argument("--out", default=None, help="output image path")
    args = parser.parse_args(argv)

    hist_dir = os.path.join(args.folder_exp, "history")
    if not os.path.isdir(hist_dir):
        sys.exit(f"no history dir at {hist_dir}")

    curves = {}
    for fname in sorted(os.listdir(hist_dir)):
        try:
            iters, vals = learning_curve(
                os.path.join(hist_dir, fname),
                iterations_per_epoch=args.iterations_per_epoch,
            )
        except Exception as e:
            print(f"skipping {fname}: {e}")
            continue
        curves[fname.replace("history_", "")] = (iters, vals)

    if not curves:
        sys.exit("no readable history files")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; curve data:")
        for name, (iters, vals) in curves.items():
            print(f"{name}: best val_loss {min(vals):.6f} "
                  f"at iter {iters[list(vals).index(min(vals))]}")
        return

    fig, ax = plt.subplots(figsize=(8, 5))
    for name, (iters, vals) in curves.items():
        ax.plot(iters, vals, label=name)
    ax.set_xlabel("training iterations")
    ax.set_ylabel("validation loss")
    ax.legend(fontsize=7)
    ax.grid(True, alpha=0.3)
    out = args.out or os.path.join(args.folder_exp, "learning_curves.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    print(f"wrote {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
