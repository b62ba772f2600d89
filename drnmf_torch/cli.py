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

Multi-rank layouts (the JAX CLI's mesh flags): ``--dp N`` trains over N
data-parallel ranks and splits each split's scoring over them, ``--tp N``
splits the DR-NMF recurrence's 2r axis over N ranks (composes with
``--dp`` into a dp x tp layout), ``--fsdp`` shards parameters and Adam
moments over dp.  With more than one rank the command starts its ranks
itself (spawned processes, ``parallel.mesh``) and prints the layout and
the backend: NCCL where each rank has a card, gloo where ranks share one
(as on a one-card machine) or run on the CPU.  The numbers are the
single-process run's; ``fsdp`` stays out of the artifact hash.
"""

import argparse
import os
import sys

from . import pipeline
from .config import load_yaml
from .device import resolve_device

# the longest a rank waits at one collective for the others (rank 0
# enhances a split alone while they wait to score it)
RANK_TIMEOUT_S = 7200.0


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
    parser.add_argument("--dp", default="auto", metavar="N",
                        help="data-parallel ranks ('auto': the cards, one "
                        "with --device cpu; '0'/'1': off)")
    parser.add_argument("--tp", default=0, type=int, metavar="N",
                        help="tensor-parallel ranks for the DR-NMF "
                        "recurrence (unfolded_snmf only; composes with "
                        "--dp)")
    parser.add_argument("--fsdp", action="store_true",
                        help="shard parameters and Adam moments over the "
                        "dp ranks (trained models; needs --dp > 1)")
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

    n_tp = max(args.tp, 1)
    if n_tp > 1 and model_type != "unfolded_snmf":
        parser.error("--tp applies to the DR-NMF recurrence only")
    if args.fsdp and model_type not in ("unfolded_snmf", "lstm"):
        parser.error("--fsdp applies to trained models only")
    if args.dp == "auto":
        import torch

        n_dev = (torch.cuda.device_count()
                 if torch.device(args.device).type == "cuda" else 1)
        n_dp = max(n_dev // n_tp, 1)
    else:
        try:
            n_dp = max(int(args.dp), 1)
        except ValueError:
            parser.error(f"--dp takes 'auto' or a count, not {args.dp!r}")
    if n_tp > 1 and (2 * int(params_model["r"])) % n_tp:
        parser.error(f"--tp {n_tp} does not divide the hidden dimension "
                     f"2r = {2 * int(params_model['r'])}")
    if args.fsdp:
        if n_dp < 2:
            parser.error("--fsdp requires a data-parallel mesh (--dp > 1)")
        # run control, not model identity: the same numbers, another layout
        params_model["fsdp"] = True
    run_args = (model_type, params_model, params_data, folder_exp,
                dict(flag_recompute=args.recompute,
                     flag_score=not args.no_score,
                     flag_rescore=args.rescore,
                     compute_pesq=not args.no_pesq, splits=splits),
                not args.quiet)
    if n_dp * n_tp == 1:
        return _run(None, *run_args, device=args.device)
    from .parallel import run_ranks

    return run_ranks(_rank, n_dp * n_tp,
                     args=(n_dp, n_tp, args.device, run_args),
                     device=args.device, timeout_s=RANK_TIMEOUT_S)[0]


_RUNNERS = {"unfolded_snmf": "run_unfolded_snmf", "lstm": "run_lstm",
            "snmf": "run_snmf"}


def _run(mesh, model_type, params_model, params_data, folder_exp, options,
         verbose, device="cuda"):
    run = getattr(pipeline, _RUNNERS[model_type])
    return run(params_model, params_data, folder_exp, verbose=verbose,
               device=device, mesh=mesh, **options)


def _rank(rank, n_dp, n_tp, device, run_args):
    """One rank of a multi-rank run (started by ``run_ranks``): the layout,
    printed by rank 0, then the runner; only rank 0 speaks."""
    from .parallel import make_mesh_2d
    from .parallel.mesh import rank_device

    mesh = make_mesh_2d(n_dp, n_tp, rank_device(rank, device))
    verbose = run_args[-1] and rank == 0
    if verbose:
        print(f"mesh: {mesh.describe()}", flush=True)
    return _run(mesh, *run_args[:-1], verbose)


if __name__ == "__main__":
    main(sys.argv[1:])
