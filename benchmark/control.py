"""The readings that a cell's limits are set from, at the cell's own size:
for each seed, the numbers that the comparison gives for the program (a
short window, then the check), for the control (the reference computed
with every product in TF32, in the program's place) and, with
``--faults``, for the program with each fault of ``faults.py`` planted.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 4] [--faults] [--no-control]

One JSON line a seed on standard output.  The benchmark's own runs never
run this."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def program_numbers(bench, name, seed, seconds, device, keep=False):
    """The numbers a run's check gives after a window of ``seconds`` that
    runs every distinct call of the corpus at least once; with ``keep``
    also the driver, its program state released."""
    workload = bench.workload(name)
    config = bench.config(workload["config"])
    traffic = bench.traffic(workload["traffic"])
    mod = bench.driver(traffic["kind"], config["family"])
    drv = mod.Driver(config, traffic, seed, device, False)
    distinct = len(getattr(drv, "corpus", []))
    t0, calls = time.perf_counter(), 0
    while calls < distinct or time.perf_counter() - t0 < seconds:
        drv.call(calls)
        calls += 1
    drv.sync()
    numbers = drv.check()
    return (numbers, drv, mod) if keep else numbers


def readings(name, seed, seconds, device, root=None, faults=False,
             control=True):
    from benchmark.faults import FAULTS
    from benchmark.harness import Bench

    bench = Bench(root)
    out = {"seed": seed}
    numbers, drv, mod = program_numbers(bench, name, seed, seconds, device,
                                        keep=True)
    out["program"] = numbers
    if control:
        want = drv.reference_answers("f32")
        low = drv.reference_answers("tf32")
        if isinstance(low, dict):
            low = {k: [v] for k, v in low.items()}
        out["control"] = mod.compare(low, want)
    del drv
    if faults:
        workload = bench.workload(name)
        kind = (bench.traffic(workload["traffic"])["kind"],
                bench.config(workload["config"])["family"])
        out["faults"] = {}
        for fault, plant in FAULTS[kind].items():
            with plant():
                out["faults"][fault] = program_numbers(bench, name, seed,
                                                       seconds, device)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--faults", action="store_true")
    parser.add_argument("--no-control", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds, "cuda",
                                  ROOT, args.faults, not args.no_control)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
