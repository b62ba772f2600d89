"""A temporary checkout of the benchmark with tiny cells that run on the
CPU in seconds: the same drivers, yardstick and reference at toy sizes."""

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

TINY_DRNMF = {"family": "drnmf", "K_layers": 3, "r": 8, "alph": 6.0,
              "lam1": 0.05, "batch_size": 4, "clipnorm": 0.0,
              "learning_rate": 0.01, "params_trainable": ["log_D", "log_alph"],
              "params_untied": ["log_D", "log_alph"], "n_fft": 32, "hop": 8,
              "fs": 2000, "mask_value": -1.0, "dictionary_power": 16}
TINY_SNMF = {"family": "snmf", "r": 6, "lam1": 0.1, "cf": "ed",
             "infer_max_iter": 30, "random_seed": 3, "frame_chunk": 100000,
             "n_fft": 32, "hop": 8, "fs": 2000,
             "dictionary_power": 16}
LENGTHS = {"median_s": 0.1, "sigma": 0.35, "min_s": 0.05, "max_s": 0.2}
TINY_OFFLINE = {"kind": "offline", "lengths": LENGTHS,
                "signals_per_call": {"drnmf": 5, "snmf": 4},
                "distinct_calls": {"drnmf": 2, "snmf": 2},
                "sample_per_call": {"drnmf": 2, "snmf": 2}}
TINY_TRAIN = {"kind": "train", "lengths": LENGTHS, "batch": 4, "maxlen": 16,
              "batches_per_epoch": 4, "checked_steps": 3}
# CPU runs of the program run its kernels' plain versions in float32
# (CPU readings at seed 7: the program 1.8e-7 / 6.3e-8 and 0, 7.9e-7,
# 1.8e-7; the control 6.3e-4 / 1.3e-4 and 2.4e-4, 1.1e-3, 2.1e-4)
LIMITS = {"offline": {"wave_rel_l2": 2e-5},
          "train": {"loss_gap": 2e-5, "grad_gap": 1e-4, "change_gap": 2e-5}}
CELLS = {"tiny-drnmf.tiny-offline": ("tiny-drnmf", "tiny-offline"),
         "tiny-snmf.tiny-offline": ("tiny-snmf", "tiny-offline"),
         "tiny-drnmf.tiny-train": ("tiny-drnmf", "tiny-train")}


def make_root(tmp, cells=CELLS):
    """A checkout under ``tmp`` with BENCHMARK.json, a copy of the
    benchmark's folder and the tiny cells' files; returns its path."""
    root = Path(tmp) / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cfg in (("tiny-drnmf", TINY_DRNMF), ("tiny-snmf", TINY_SNMF)):
        path = root / "benchmark" / "configs" / f"{name}.json"
        path.write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "toy", "reduced": [],
                                "file": f"benchmark/configs/{name}.json",
                                "why": "toy"})
    for name, traffic in (("tiny-offline", TINY_OFFLINE),
                          ("tiny-train", TINY_TRAIN)):
        (root / "benchmark" / "traffic" / f"{name}.json").write_text(
            json.dumps(traffic))
    for cell, (config, traffic) in cells.items():
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "toy"})
        kind = json.loads((root / "benchmark" / "traffic"
                           / f"{traffic}.json").read_text())["kind"]
        limits = {k: {"limit": v} for k, v in LIMITS[kind].items()}
        (root / "benchmark" / "limits" / f"{cell}.json").write_text(
            json.dumps({"numbers": limits}))
    # each metric's tiny cells: those of the kind and family it lists
    def kind_family(config, traffic):
        return ("train" if "train" in traffic else "offline",
                config.split("-")[-1] if config.startswith("tiny")
                else config.split("-")[0])

    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            listed = {kind_family(*w.split(".")) for w in m["workloads"]}
            m["workloads"] += [c for c, pair in cells.items()
                               if kind_family(*pair) in listed]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root
