"""WASPAA 2017 paper replication: generate the full model grid and run it
through the port's CLI (counterpart of ``scripts/run_waspaa2017.py``).

Equivalent of the reference's run_waspaa2017.sh:1-76 -- the 10-model grid
(param-count-matched SNMF / LSTM / DR-NMF pairs, BASELINE.md "Model grid")
trained and scored on 10% (downsample=10) then 100% (downsample=1) of the
CHiME2 training set, followed by the score table (print_scores.py
equivalent) and learning curves.

Grid (run_waspaa2017.sh:14-35):
    SNMF    r=100            SNMF    r=1000
    LSTM    K=2 N=54         DR-NMF  K=2 r=100  (2r=200)
    LSTM    K=5 N=70         DR-NMF  K=5 r=100
    LSTM    K=2 N=244        DR-NMF  K=2 r=1000 (2r=2000)
    LSTM    K=5 N=250        DR-NMF  K=5 r=1000

The config files get the JAX script's hashed names (the same
``config_hash``), and each run is ``python -m drnmf_torch.cli -c <config>
-d <data config>`` with ``--cli-args`` appended (e.g. ``--dp 2`` starts
ranks, ``--device cpu`` runs without a card).

Usage:
    python -m drnmf_torch.create_taskfiles /path/to/chime2  # taskfiles first
    python -m drnmf_torch.run_waspaa2017                    # full replication
    python -m drnmf_torch.run_waspaa2017 --generate-only    # just write configs
    python -m drnmf_torch.run_waspaa2017 --downsamples 10   # 10% condition only
"""

import argparse
import os
import sys

from .config import config_hash, dump_yaml


# ISTA step sizes per dictionary size (reference enhance.py:608-614)
ALPH_BY_R = {100: 50.0, 500: 200.0, 1000: 400.0}


def snmf_config(r):
    return {
        "r": r,
        "lam1": 1.0,
        "cf": "ed",
        "snmf_max_iter": 1000,
        "snmf_conv_eps": 1e-4,
        "infer_max_iter": 200,
        "random_seed": 2016,
    }


def drnmf_config(K, r):
    return {
        "K_layers": K,
        "r": r,
        "alph": ALPH_BY_R[r],
        "lam1": 1.0,
        "batch_size": 32,
        "clipnorm": 0.0,
        "epochs": 1200 if (K == 5 and r == 1000) else 400,
        "learning_rate": 1e-3,
        "loss": "mse_of_masked",
        "optimizer": "adam",
        "params_trainable": ["log_D", "log_alph"],
        "params_untied": ["log_D", "log_alph"],
        "patience": 50,
        "snmf_max_iter": 1000,
        "snmf_conv_eps": 1e-4,
    }


def lstm_config(K, hidden):
    return {
        "K_layers": K,
        "hidden_dim": hidden,
        "batch_size": 32,
        "clipnorm": 1.0,
        "epochs": 400,
        "learning_rate": 1e-4,
        "loss": "mse_of_masked",
        "optimizer": "adam",
        "patience": 50,
    }


# (model_type, config) in the reference's run order (SNMF dictionaries first:
# their cached dictionaries initialize the DR-NMF models)
GRID = [
    ("snmf", snmf_config(100)),
    ("snmf", snmf_config(1000)),
    ("lstm", lstm_config(2, 54)),
    ("unfolded_snmf", drnmf_config(2, 100)),
    ("lstm", lstm_config(5, 70)),
    ("unfolded_snmf", drnmf_config(5, 100)),
    ("lstm", lstm_config(2, 244)),
    ("unfolded_snmf", drnmf_config(2, 1000)),
    ("lstm", lstm_config(5, 250)),
    ("unfolded_snmf", drnmf_config(5, 1000)),
]


def data_config(downsample, taskfile_dir="."):
    cfg = {
        "downsample": downsample,
        "maxlen": 500,
        "params_stft": {"N": 512, "hop": 128, "nch": 1},
        "transform_x": "mag",
        "transform_y": "mag",
        "datafile_train": f"chime2_si_tr_s_ds{downsample}.hdf5",
        "datafile_valid": "chime2_si_dt_05.hdf5",
        "datafile_test": "chime2_si_et_05.hdf5",
    }
    for split, (x, y) in {
        "train": ("train_noisy", "train_clean"),
        "valid": ("valid_noisy", "valid_clean"),
        "test": ("test_noisy", "test_clean"),
    }.items():
        cfg[f"taskfile_x_{split}"] = os.path.join(
            taskfile_dir, f"taskfile_chime2_{x}.txt")
        cfg[f"taskfile_y_{split}"] = os.path.join(
            taskfile_dir, f"taskfile_chime2_{y}.txt")
    return cfg


def demo_grid(epochs=40):
    """The FULL 10-model paper grid (same model sizes: SNMF r in {100,1000},
    LSTM K/N pairs, DR-NMF K in {2,5} x r in {100,1000}) at a demo training
    schedule -- epochs cut from 400/1200 to ``epochs`` and SNMF dictionary
    iterations from 1000 to 200 -- so the whole grid runs end-to-end on one
    chip in minutes instead of GPU-weeks.  Used with ``--data-config`` and a
    synthetic corpus when the licensed CHiME2 data is unavailable."""
    out = []
    for model_type, cfg in GRID:
        c = dict(cfg)
        if model_type == "snmf":
            c["snmf_max_iter"] = 200
            c["infer_max_iter"] = 100
        else:
            c["epochs"] = epochs
            # hash-excluded run control: interrupted demo runs continue
            # exactly instead of restarting (train/loop.py elastic resume)
            c["resume"] = True
            if "snmf_max_iter" in c:
                c["snmf_max_iter"] = 200  # share the snmf runs' dictionaries
        out.append((model_type, c))
    return out


def paper_grid():
    """The 10-model grid at the PAPER training schedule (epochs 400, or
    1200 for the K=5/r=1000 flagship -- run_waspaa2017.sh:14-35) with
    elastic resume on.  SNMF dictionary iterations stay at the demo 200
    (the dictionaries that initialized every model trained in this tree;
    RESULTS.md notes the deviation), so `--demo` runs seed `--paper` runs:
    same dictionaries, and seed_paper_runs_from_demo() extends a finished
    40-epoch demo model to the paper schedule via the resume state instead
    of retraining from scratch."""
    out = []
    for model_type, cfg in GRID:
        c = dict(cfg)
        if model_type == "snmf":
            c["snmf_max_iter"] = 200
            c["infer_max_iter"] = 100
        else:
            c["resume"] = True
            if "snmf_max_iter" in c:
                c["snmf_max_iter"] = 200
        out.append((model_type, c))
    return out


def seed_paper_runs_from_demo(setup, demo_epochs=40):
    """For each paper-schedule model without artifacts, seed its elastic-
    resume state from the finished demo-schedule run of the same model (the
    configs differ only in `epochs`, which the hash includes): training
    then RESUMES from epoch ``demo_epochs`` exactly -- the demo grid
    becomes a warm start for the paper grid."""
    import shutil

    for (t_d, c_d), (t_p, c_p) in zip(demo_grid(demo_epochs), paper_grid()):
        if t_d == "snmf":
            continue  # identical configs; nothing to seed
        h_d = config_hash(c_d, exclude=("resume",))
        h_p = config_hash(c_p, exclude=("resume",))
        if h_d == h_p:
            continue
        src = os.path.join(setup, "models", f"model_{t_d}_{h_d}.npz")
        dst = os.path.join(setup, "models", f"model_{t_p}_{h_p}.npz")
        if os.path.exists(dst) or os.path.exists(dst + ".train_state"):
            continue
        # need BOTH files: a demo run that never improved on val (e.g.
        # diverged to NaN) writes .train_state every epoch but no
        # best-checkpoint .npz -- skip it rather than crash the --paper run
        if not (os.path.exists(src) and os.path.exists(src + ".train_state")):
            continue
        shutil.copy(src, dst)
        shutil.copy(src + ".train_state", dst + ".train_state")
        hist_src = os.path.join(setup, "history", f"history_{t_d}_{h_d}")
        if os.path.exists(hist_src):
            shutil.copy(hist_src,
                        os.path.join(setup, "history", f"history_{t_p}_{h_p}"))
        print(f"   seeded {t_p} {h_p} from demo run {h_d} "
              f"(resume extends from epoch {demo_epochs})")


# miniature grid for --smoke: exercises every model family and the
# SNMF-dictionary cache reuse between the snmf and unfolded_snmf runs
SMOKE_GRID = [
    ("snmf", {"r": 8, "lam1": 0.5, "cf": "ed", "snmf_max_iter": 20,
              "snmf_conv_eps": 1e-4, "infer_max_iter": 10,
              "random_seed": 2016}),
    ("lstm", {"K_layers": 2, "hidden_dim": 8, "batch_size": 4, "clipnorm": 1.0,
              "epochs": 2, "learning_rate": 1e-4, "loss": "mse_of_masked",
              "optimizer": "adam", "patience": 50}),
    ("unfolded_snmf", {"K_layers": 2, "r": 8, "alph": 10.0, "lam1": 0.5,
                       "batch_size": 4, "clipnorm": 0.0, "epochs": 2,
                       "learning_rate": 1e-3, "loss": "mse_of_masked",
                       "optimizer": "adam",
                       "params_trainable": ["log_D", "log_alph"],
                       "params_untied": ["log_D", "log_alph"],
                       "patience": 50, "snmf_max_iter": 20,
                       "snmf_conv_eps": 1e-4}),
]


def generate_configs(downsample, taskfile_dir=".", grid=None,
                     data_config_path=None):
    """Write params_data.yaml + the hashed model-config grid for one setup.
    Returns (data_config_path, [model_config_paths in run order])."""
    setup = f"data_setup_downsample{downsample}"
    os.makedirs(os.path.join(setup, "configs"), exist_ok=True)
    if data_config_path is None:
        data_config_path = os.path.join(setup, "params_data.yaml")
        dump_yaml(data_config(downsample, taskfile_dir), data_config_path)
    else:
        # keep a copy in the setup dir so reporting (print_scores
        # num_train column) finds the condition's data config
        local = os.path.join(setup, "params_data.yaml")
        if os.path.abspath(local) != os.path.abspath(data_config_path):
            import shutil

            shutil.copy(data_config_path, local)
    model_paths = []
    for model_type, cfg in (grid or GRID):
        # 'resume' is run control, not model identity: hash like the
        # pipeline does so config filenames match its artifact names
        h = config_hash(cfg, exclude=("resume",))
        path = os.path.join(setup, "configs", f"params_{model_type}_{h}.yaml")
        dump_yaml(cfg, path)
        model_paths.append(path)
    return data_config_path, model_paths


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--downsamples", default="10,1",
                        help="comma-separated downsample conditions")
    parser.add_argument("--taskfile-dir", default=".")
    parser.add_argument("--generate-only", action="store_true",
                        help="write configs without training")
    parser.add_argument("--dry-run", action="store_true",
                        help="print the commands without running")
    parser.add_argument("--pesq", action="store_true",
                        help=argparse.SUPPRESS)  # PESQ is on by default now
    parser.add_argument("--no-pesq", action="store_true",
                        help="skip PESQ in scoring (on by default)")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny 3-model grid (one per family) for a fast "
                        "end-to-end check of the whole orchestration")
    parser.add_argument("--demo", action="store_true",
                        help="the full 10-model paper grid at a demo "
                        "training schedule (see demo_grid)")
    parser.add_argument("--demo-epochs", type=int, default=40)
    parser.add_argument("--paper", action="store_true",
                        help="the full 10-model grid at the PAPER schedule "
                        "(400/1200 epochs) with elastic resume; finished "
                        "--demo runs are used as warm starts (see "
                        "paper_grid / seed_paper_runs_from_demo)")
    parser.add_argument("--only", default=None,
                        help="comma-separated list of config-hash prefixes "
                        "or 1-based grid indices to run (subset selection "
                        "for sequencing long schedules)")
    parser.add_argument("--data-config", default=None,
                        help="use an existing params_data.yaml instead of "
                        "generating the CHiME2 one (e.g. a synthetic corpus)")
    parser.add_argument("--cli-args", default="",
                        help="extra arguments forwarded verbatim to "
                        "drnmf_torch.cli for every grid run (e.g. "
                        "'--dp 4 --tp 2 --fsdp' to train the whole grid "
                        "over a dp x tp layout, '--device cpu')")
    args = parser.parse_args(argv)

    from . import cli

    try:
        downsamples = [int(d) for d in args.downsamples.split(",")]
    except ValueError:
        parser.error(f"--downsamples must be comma-separated integers, "
                     f"got '{args.downsamples}'")
    if args.smoke:
        downsamples = downsamples[:1]
    if args.data_config:
        # the CLI derives its experiment dir from the data config's own
        # 'downsample'; keep configs and the final summary in that folder
        from .config import load_yaml

        downsamples = [int(load_yaml(args.data_config).get("downsample", 1))]

    grid = SMOKE_GRID if args.smoke else (
        paper_grid() if args.paper else (
            demo_grid(args.demo_epochs) if args.demo else None
        )
    )
    for ds in downsamples:
        data_path, model_paths = generate_configs(
            ds, args.taskfile_dir, grid=grid,
            data_config_path=args.data_config)
        print(f"== data setup downsample{ds}: {data_path}")
        for mp in model_paths:
            print(f"   {mp}")
        if args.paper:
            seed_paper_runs_from_demo(f"data_setup_downsample{ds}",
                                      args.demo_epochs)
        if args.generate_only:
            continue
        if args.only:
            sels = [s.strip() for s in args.only.split(",") if s.strip()]
            keep = []
            for i, mp in enumerate(model_paths):
                h = os.path.basename(mp).rsplit("_", 1)[-1].replace(".yaml", "")
                # all-digit selectors are grid indices ONLY -- a hex hash
                # can start with digits too, and matching both would let
                # `--only 2` silently pull in hash-prefix models (each an
                # hours-long training run at the paper schedule)
                if any(s == str(i + 1) if s.isdigit() else h.startswith(s)
                       for s in sels):
                    keep.append(mp)
            model_paths = keep
            print(f"== --only selection: {len(model_paths)} model(s)")
        for mp in model_paths:
            cli_argv = ["-c", mp, "-d", data_path]
            if args.no_pesq:
                cli_argv.append("--no-pesq")
            if args.cli_args:
                import shlex

                cli_argv.extend(shlex.split(args.cli_args))
            print(f"== run: python -m drnmf_torch.cli {' '.join(cli_argv)}")
            if not args.dry_run:
                cli.main(cli_argv)

    if args.generate_only or args.dry_run:
        return

    # score table (print_scores.py equivalent)
    from .reporting import summarize_experiment

    for ds in downsamples:
        setup = f"data_setup_downsample{ds}"
        rows = summarize_experiment(setup)
        print(f"\n== {setup} results")
        for row in rows:
            sdr = f"{row['mean_sdr']:.2f}" if row["mean_sdr"] is not None else "-"
            print(f"  {row['model']}: val_loss {row['val_loss']:.5f}  SDR {sdr}")


if __name__ == "__main__":
    main(sys.argv[1:])
