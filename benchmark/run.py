"""Run one cell of the benchmark once and print its result as the last line
of standard output (one JSON object), each compared number beside its
limit as the last lines of standard error.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  It exits with another code than 0, and prints no result, where CUDA
or the cards are missing, where the program cannot be imported, or where
the process has loaded JAX or the JAX package by the time the window has
closed."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "drnmf_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # every cache stays at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "benchmark_cache", sub)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import Bench, run_workload

    chips = int(Bench(ROOT).workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    result = run_workload(args.workload, args.seed, args.seconds,
                          args.trace, device="cuda", root=ROOT,
                          t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
