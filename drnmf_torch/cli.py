"""Command line: an experiment from two YAML files (counterpart of
``drnmf_tpu/cli.py``; the reference's enhance.py:459-475)::

    python -m drnmf_torch.cli -c <model config YAML> -d <data config YAML>

The model family comes from the config file's name, as in the reference
('unfolded_snmf' before 'snmf' before 'lstm', enhance.py:529-538).  The
run trains (or reuses the cached artifacts), writes the enhanced wavs of
``--splits`` and scores them (per SNR condition and overall, cached under
``<exp-dir>/scores/``): ``--no-score`` enhances only, ``--no-pesq`` writes
-1.0 for PESQ, ``--rescore`` ignores cached scores, ``--splits ''``
trains only.  Runs on the card unless ``--device cpu``.
"""

import argparse
import os
import sys

from . import pipeline
from .config import load_yaml
from .device import resolve_device


def dispatch_model_type(configfile: str) -> str:
    name = os.path.basename(configfile)
    if "unfolded_snmf" in name:
        return "unfolded_snmf"
    if "snmf" in name:
        return "snmf"
    if "lstm" in name:
        return "lstm"
    raise ValueError(
        f"cannot infer model type from config filename '{configfile}' "
        "(expected a 'unfolded_snmf', 'snmf', or 'lstm' substring)")


def main(argv=None):
    """Parse ``argv`` and run the experiment; returns what the pipeline's
    runner returns (for callers in the same process)."""
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("-c", "--config", required=True,
                        help="model config YAML")
    parser.add_argument("-d", "--data", required=True,
                        help="data setup YAML")
    parser.add_argument("--exp-dir", default=None,
                        help="experiment dir (default "
                        "data_setup_downsample<d>)")
    parser.add_argument("--recompute", action="store_true")
    parser.add_argument("--rescore", action="store_true",
                        help="recompute cached score files")
    parser.add_argument("--no-score", action="store_true",
                        help="enhance without scoring")
    parser.add_argument("--no-pesq", action="store_true",
                        help="skip PESQ when scoring (its column is -1.0)")
    parser.add_argument("--splits", default="valid,test",
                        help="comma-separated splits to enhance and score")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when "
                        "asked)")
    parser.add_argument("-q", "--quiet", action="store_true")
    args = parser.parse_args(argv)

    splits = tuple(s for s in args.splits.split(",") if s)
    resolve_device(args.device)  # raises without CUDA unless --device cpu
    for path, what in ((args.config, "model config"),
                       (args.data, "data config")):
        if not os.path.isfile(path):
            parser.error(f"{what} not found: {path}")
    try:
        model_type = dispatch_model_type(args.config)
    except ValueError as e:
        parser.error(str(e))
    params_model = load_yaml(args.config)
    params_data = load_yaml(args.data)
    folder_exp = args.exp_dir or (
        "data_setup_downsample%d" % params_data.get("downsample", 1))
    run = {"unfolded_snmf": pipeline.run_unfolded_snmf,
           "lstm": pipeline.run_lstm, "snmf": pipeline.run_snmf}[model_type]
    return run(params_model, params_data, folder_exp,
               flag_recompute=args.recompute, flag_score=not args.no_score,
               flag_rescore=args.rescore, compute_pesq=not args.no_pesq,
               verbose=not args.quiet, splits=splits, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
