#!/usr/bin/env python3
"""Time kernel B1 (``drnmf_scan_factored``) in two occupancy variants and
two row tiles on one NVIDIA GPU: the record of its tuning.

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit:

    python3 tools/b1_variants.py

Variants of ``ops/csrc/drnmf_scan_factored.cu``, each built with the
package's nvcc flags into ``build/drnmf_torch_kernels/``: ``lb1`` is the
source as it is (``__launch_bounds__(256)``: ptxas may take up to 255
registers a thread, one block of the 64-row kernel an SM); ``lb2`` asks
for two blocks an SM (``__launch_bounds__(256, 2)``: at most 128
registers, spills where more are needed).  Each runs with the plan's row
tile and with 32-row tiles, at the flagship widths (K=5, 2r=2000, F=257;
the model of tests/test_torch_cuda.py, seed 0) and B x T = 256 x 1,021,
64 x 16 and 1 x 1,021, in turns (a b c d d c b a), ms a call from CUDA
events.  Every output must equal the first variant's bit for bit: a row's
sums do not depend on the tile or the grid.  Prints one JSON line for the
card, one for each build (ptxas's registers and spills, blocks an SM) and
one for each shape.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from drnmf_torch.models import drnmf  # noqa: E402
from drnmf_torch.ops import build, drnmf_scan  # noqa: E402
from test_torch_cuda import _model  # noqa: E402

KERNEL = ("__global__ void __launch_bounds__(THREADS)\n"
          "drnmf_scan_factored_kernel")


def build_variants():
    """{name: ctypes library} of the two launch-bound variants."""
    src = (build.CSRC / drnmf_scan.SOURCE).read_text()
    assert KERNEL in src
    texts = {"lb1": src,
             "lb2": src.replace(KERNEL, KERNEL.replace("(THREADS)",
                                                       "(THREADS, 2)"))}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = build.BUILD_DIR / f"b1_variant_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.drnmf_scan_factored.argtypes = [ptr] * 16 + [i32] * 13 + [ptr]
        lib.drnmf_scan_factored.restype = i32
        lib.drnmf_scan_factored_capacity.argtypes = [i32]
        lib.drnmf_scan_factored_capacity.restype = i32
        lib.drnmf_cuda_error_string.argtypes = [i32]
        lib.drnmf_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        print(json.dumps({
            "build": name,
            "ptxas": [line.strip() for line in log.splitlines()
                      if "registers" in line or "spill" in line],
            "blocks_per_sm_by_row_tile": {
                tm: lib.drnmf_scan_factored_capacity(tm) / n_sm
                for tm in drnmf_scan.DENSE_TILES}}), flush=True)
    return libs


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}), flush=True)
    libs = build_variants()
    row_tile = drnmf_scan.row_tile
    cfg, params, rng = _model(0, 257, 1000, 5, "cuda")
    runs = [(lib, tm) for lib in libs for tm in (None, 32)]
    for bsz, t_len in ((256, 1021), (64, 16), (1, 1021)):
        x = torch.from_numpy(rng.uniform(0, 1, (bsz, t_len, 257))
                             .astype(np.float32)).cuda()
        args = drnmf.factored_scan_operands(
            params, cfg, x, drnmf.step_mask_from_input(x, cfg.mask_value))
        first, line = None, {"shape": [bsz, t_len]}
        try:
            for name, tm in runs + runs[::-1]:
                drnmf_scan._library = lambda lib=libs[name]: lib
                drnmf_scan.row_tile = (row_tile if tm is None
                                       else lambda b, tm=tm: tm)
                out = drnmf_scan.drnmf_scan_factored(*args)
                first = out if first is None else first
                key = f"{name}_tm{drnmf_scan.row_tile(bsz)}"
                entry = line.setdefault(key, {"ms": [], "bits_equal": True})
                entry["bits_equal"] &= bool(torch.equal(out, first))
                entry["ms"].append(cuda_ms(
                    lambda: drnmf_scan.drnmf_scan_factored(*args),
                    2 if t_len > 100 else 20))
        finally:
            drnmf_scan.row_tile = row_tile
        print(json.dumps(line), flush=True)
        if not all(v["bits_equal"] for k, v in line.items() if k != "shape"):
            sys.exit("a variant's output differs from the first's")


if __name__ == "__main__":
    main()
