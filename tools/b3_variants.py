#!/usr/bin/env python3
"""Time kernel B3 (``drnmf_scan_dense``) in ring-depth, stretch-count and
occupancy variants on one NVIDIA GPU: the record of its tuning.

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit:

    python3 tools/b3_variants.py

Builds of ``ops/csrc/drnmf_scan_dense.cu`` with the package's nvcc flags
into ``build/drnmf_torch_kernels/``: ``ring`` is the source as it is (a
``cp.async`` ring of 10, 8, 6 and 4 stages at 8, 16, 32 and 64 columns);
``shallow`` has 6, 6, 4 and 3 stages, which leaves more shared memory
free and fewer weight bytes in flight.  Each build runs with a later
layer cut into 8 stretches (the plan's: 16 row tiles x 8 = 128 items a
batch tile, one an SM), into 9 (144 items: 12 SMs run two, as the first
design's stretches of 512 cut per segment did) and into 16; at 256 rows
also with the grid held to one block an SM.  Inputs: the operands of
tests/test_torch_cuda.py (every term moves the output) at the flagship
widths (K=5, 2r=2000, F=257) and B x T = 256 x 1,021, 64 x 16 and
1 x 1,021, the variants in turns (a b c d d c b a), ms a call from CUDA
events.  Variants with the same stretch count must give the same bits.
Also the error of B3 (8 and 16 stretches) and of its plain version (f32,
cuBLAS) against the plain version in float64 at 256 x 1,021.  Prints one
JSON line for the card, one for each build (ptxas's registers and spills,
blocks an SM by batch tile) and one for each shape.
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

from drnmf_torch.ops import build, drnmf_scan  # noqa: E402
from test_torch_cuda import _dense_args  # noqa: E402

RING = ("  static constexpr int STAGES =\n"
        "      NI == 8 ? 10 : (NI == 16 ? 8 : (NI == 32 ? 6 : 4));")
SHALLOW = "  static constexpr int STAGES = NI <= 16 ? 6 : (NI <= 32 ? 4 : 3);"


def build_variants():
    """{name: ctypes library} of the ring-depth variants."""
    src = (build.CSRC / drnmf_scan.DENSE_SOURCE).read_text()
    assert RING in src
    texts = {"ring": src, "shallow": src.replace(RING, SHALLOW)}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = build.BUILD_DIR / f"b3_variant_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.drnmf_scan_dense.argtypes = [ptr] * 10 + [i32] * 11 + [ptr]
        lib.drnmf_scan_dense.restype = i32
        lib.drnmf_scan_dense_capacity.argtypes = [i32]
        lib.drnmf_scan_dense_capacity.restype = i32
        lib.drnmf_cuda_error_string.argtypes = [i32]
        lib.drnmf_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        print(json.dumps({
            "build": name,
            "ptxas": [line.strip() for line in log.splitlines()
                      if "registers" in line or "spill" in line],
            "blocks_per_sm_by_batch_tile": {
                ni: lib.drnmf_scan_dense_capacity(ni) / n_sm
                for ni in drnmf_scan.DENSE_BATCH_TILES}}), flush=True)
    return libs


class OneBlockAnSM:
    """A library whose capacity query says one block an SM."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        if name == "drnmf_scan_dense_capacity":
            n_sm = torch.cuda.get_device_properties(0).multi_processor_count
            return lambda ni: min(self.lib.drnmf_scan_dense_capacity(ni),
                                  n_sm)
        return getattr(self.lib, name)


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


def run(lib, stretches, args):
    """B3 with this library and stretch count (the plan's otherwise)."""
    saved = drnmf_scan._dense_library, drnmf_scan.DENSE_STRETCHES
    drnmf_scan._dense_library = lambda: lib
    drnmf_scan.DENSE_STRETCHES = stretches
    try:
        return drnmf_scan.drnmf_scan_dense(*args)
    finally:
        drnmf_scan._dense_library, drnmf_scan.DENSE_STRETCHES = saved


def errors_against_f64(libs, args):
    """Max abs and relative error of B3 (8, 16 stretches) and of the f32
    plain version against the plain version in float64."""
    exact = drnmf_scan.drnmf_scan_dense_reference(
        *[a.double() if a.is_floating_point() else a for a in args])
    outs = {"plain_f32": drnmf_scan.drnmf_scan_dense_reference(*args)}
    for stretches in (8, 16):
        outs[f"b3_s{stretches}"] = run(libs["ring"], stretches, args)
    res = {}
    for name, out in outs.items():
        diff = (out.double() - exact).abs()
        res[name] = {"max_abs": diff.max().item(),
                     "max_rel": (diff / exact.abs().clamp_min(1e-30))
                     .max().item(),
                     "mean_signed": (out.double() - exact).mean().item()}
    res["max_abs_out"] = exact.abs().max().item()
    return res


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}), flush=True)
    libs = build_variants()
    rng = np.random.default_rng(0)
    for bsz, t_len in ((256, 1021), (64, 16), (1, 1021)):
        args = _dense_args(rng, bsz, t_len, 257, 1000, 5, "cuda")
        runs = [(name, stretches, False) for name in libs
                for stretches in (8, 9, 16)]
        if bsz == 256:
            runs += [(name, 8, True) for name in libs]
        first, line = {}, {"shape": [bsz, t_len]}
        for name, stretches, one in runs + runs[::-1]:
            lib = OneBlockAnSM(libs[name]) if one else libs[name]
            out = run(lib, stretches, args)
            first.setdefault(stretches, out)
            key = f"{name}_s{stretches}" + ("_1block" if one else "")
            entry = line.setdefault(key, {"ms": [], "bits_equal": True})
            entry["bits_equal"] &= bool(torch.equal(out, first[stretches]))
            entry["ms"].append(cuda_ms(lambda: run(lib, stretches, args),
                                       2 if t_len > 100 else 20))
        if bsz == 256:
            line["errors_against_f64"] = errors_against_f64(libs, args)
        print(json.dumps(line), flush=True)
        if not all(v.get("bits_equal", True) for k, v in line.items()
                   if isinstance(v, dict)):
            sys.exit("a variant's output differs from another's with the "
                     "same stretches")


if __name__ == "__main__":
    main()
