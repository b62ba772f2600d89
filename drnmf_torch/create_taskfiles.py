"""Write CHiME2 taskfiles: sorted wav lists per split/condition
(counterpart of ``scripts/create_taskfiles.py``).

Equivalent of the reference's create_taskfiles.sh:1-16 (find | sort -u over
the isolated/ (noisy) and scaled/ (clean) trees for si_tr_s / si_dt_05 /
si_et_05), without shelling out.

Usage:
    python -m drnmf_torch.create_taskfiles /path/to/chime2-wsj0 [--out-dir DIR]
"""

import argparse
import os
import sys


SPLITS = {
    "train": "si_tr_s",
    "valid": "si_dt_05",
    "test": "si_et_05",
}
CONDITIONS = {"noisy": "isolated", "clean": "scaled"}


def find_wavs(root):
    out = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".wav"):
                out.append(os.path.join(dirpath, f))
    return sorted(set(out))


def write_taskfiles(chime2_path, out_dir="."):
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for split, subset in SPLITS.items():
        for cond, tree in CONDITIONS.items():
            root = os.path.join(chime2_path, tree, subset)
            wavs = find_wavs(root)
            path = os.path.join(out_dir, f"taskfile_chime2_{split}_{cond}.txt")
            with open(path, "w") as f:
                f.write("\n".join(wavs) + ("\n" if wavs else ""))
            written[f"{split}_{cond}"] = path
            print(f"{path}: {len(wavs)} files")
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("chime2_path", help="CHiME2 WSJ0 root (contains "
                        "isolated/ and scaled/)")
    parser.add_argument("--out-dir", default=".")
    args = parser.parse_args(argv)
    return write_taskfiles(args.chime2_path, args.out_dir)


if __name__ == "__main__":
    main(sys.argv[1:])
