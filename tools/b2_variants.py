#!/usr/bin/env python3
"""Time kernel B2 (``drnmf_scan_factored(..., interleave=True)``) in chain,
tile, stretch and ring-depth variants on one NVIDIA GPU: the record of its
tuning.

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit:

    python3 tools/b2_variants.py

Builds of ``ops/csrc/drnmf_scan_factored_interleaved.cu`` with the
package's nvcc flags into ``build/drnmf_torch_kernels/``: ``two`` is the
source as it is (two chains: each wait leaves the newest group of
products running); ``one`` is built with ``-DB2_CHAINS=1`` (every group
waited for before the next issues); ``shallow`` with ``-DB2_RING=3`` (a
three-stage ring, one tile copied ahead).  Each runs with the plan's
batch tile; ``two`` also with the other batch tile (8 or 16 columns a
chain), with the back-projection cut into 8 stretches of 2r instead of
16, and, at 64 and 256 rows, as one chain over the whole batch (chain A
takes every row, so each wait still leaves the chain's own older group
running) at 8 and 16 columns an item.  Inputs: the model of
tests/test_torch_cuda.py (seed 0) at the flagship widths (K=5, 2r=2000,
F=257) and B x T = 256 x 1,021, 64 x 16 and 1 x 1,021, the variants in
turns (a b c d d c b a), ms a call from CUDA events.  Builds at the same
tile and stretches must give the same bits; whether other tiles and one
chain do is reported.  Also the error of B2, of B1 and of the f32 plain
version against the plain version in float64 at 256 x 1,021; and what a
call of B1 and of B2 costs besides its steps (64 rows over 16, 64 and 256
steps), with one B2 call at 64 x 16 split by device kernel
(``torch.profiler``) and the host time of its wrapper.  Prints one JSON
line for the card, one for each build (ptxas's registers, spills and any
wgmma serialisation; blocks an SM by batch tile), one for each shape and
one for the cost of a call.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from chip_smoke import profiled  # noqa: E402
from drnmf_torch.models import drnmf  # noqa: E402
from drnmf_torch.ops import build, drnmf_scan  # noqa: E402
from test_torch_cuda import _model  # noqa: E402

BUILDS = {"two": [], "one": ["-DB2_CHAINS=1"], "shallow": ["-DB2_RING=3"]}


def build_variants():
    """{name: ctypes library} of the builds."""
    src = build.CSRC / drnmf_scan.INTERLEAVED_SOURCE
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in BUILDS.items():
        so = build.BUILD_DIR / f"b2_variant_{name}.so"
        procs[name] = so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", str(so),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.drnmf_scan_factored_interleaved.argtypes = ([ptr] * 15
                                                        + [i32] * 14 + [ptr])
        lib.drnmf_scan_factored_interleaved.restype = i32
        lib.drnmf_scan_factored_interleaved_capacity.argtypes = [i32]
        lib.drnmf_scan_factored_interleaved_capacity.restype = i32
        lib.drnmf_cuda_error_string.argtypes = [i32]
        lib.drnmf_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
        print(json.dumps({
            "build": name, "flags": BUILDS[name],
            "ptxas": [line.strip() for line in log.splitlines()
                      if "registers" in line or "spill" in line
                      or "wgmma" in line],
            "blocks_per_sm_by_batch_tile": {
                ni: lib.drnmf_scan_factored_interleaved_capacity(ni) / n_sm
                for ni in drnmf_scan.INTERLEAVED_BATCH_TILES}}), flush=True)
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


def run(lib, args, ni=None, bp_stretches=None, one_chain=False):
    """B2 with this library, batch tile (the plan's when None) and
    back-projection stretches (the plan's when None); ``one_chain``: chain
    A takes every row and chain B none."""
    saved = (drnmf_scan._interleaved_library,
             drnmf_scan.interleaved_batch_tile,
             drnmf_scan.interleaved_scan_plan,
             drnmf_scan.INTERLEAVED_BP_STRETCHES)
    plan_of = drnmf_scan.interleaved_scan_plan

    def one_chain_plan(bsz, f, n2r, n_sm, capacity):
        plan = plan_of(bsz, f, n2r, n_sm, capacity)
        bt = -(-bsz // plan.ni)
        p_items = -(-n2r // plan.mt) * bt
        bp_items = plan.splits * -(-plan.fp // plan.mt) * bt
        return plan._replace(half=bsz, bpc=bt * plan.ni, p_items=p_items,
                             bp_items=bp_items,
                             grid=min(max(p_items, bp_items), capacity))

    drnmf_scan._interleaved_library = lambda: lib
    if ni is not None:
        drnmf_scan.interleaved_batch_tile = lambda *a: ni
    if bp_stretches is not None:
        drnmf_scan.INTERLEAVED_BP_STRETCHES = bp_stretches
    if one_chain:
        drnmf_scan.interleaved_scan_plan = one_chain_plan
    try:
        return drnmf_scan.drnmf_scan_factored(*args, interleave=True)
    finally:
        (drnmf_scan._interleaved_library, drnmf_scan.interleaved_batch_tile,
         drnmf_scan.interleaved_scan_plan,
         drnmf_scan.INTERLEAVED_BP_STRETCHES) = saved


def errors_against_f64(libs, args):
    """Max abs and relative error, and mean signed error, of B2, B1 and the
    f32 plain version against the plain version in float64."""
    exact = drnmf_scan.drnmf_scan_factored_reference(
        *[a.double() if a.is_floating_point() else a for a in args])
    outs = {"plain_f32": drnmf_scan.drnmf_scan_factored_reference(*args),
            "b1": drnmf_scan.drnmf_scan_factored(*args),
            "b2": run(libs["two"], args)}
    res = {}
    for name, out in outs.items():
        diff = out.double() - exact
        res[name] = {"max_abs": diff.abs().max().item(),
                     "max_rel": (diff.abs() / exact.abs().clamp_min(1e-30))
                     .max().item(),
                     "mean_signed": diff.mean().item()}
    res["max_abs_out"] = exact.abs().max().item()
    return res


def host_ms(fn, reps=20):
    """Median host ms of one call of ``fn`` on an idle card, without
    waiting for the work it queues."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def per_call_cost(params, cfg, rng):
    """What a call of B1 and of B2 costs besides its steps: 64 rows over
    16, 64 and 256 steps, a line through the first and last; for B2 also
    one call at 16 and at 256 steps split by device kernel, and the host
    time of its wrapper."""
    x = torch.from_numpy(
        rng.uniform(0, 1, (64, 256, 257)).astype(np.float32)).cuda()
    args = {}
    for t_len in (16, 64, 256):
        xt = x[:, :t_len].contiguous()
        args[t_len] = drnmf.factored_scan_operands(
            params, cfg, xt, drnmf.step_mask_from_input(xt, cfg.mask_value))
    line = {}
    for name, kwargs in (("b1", {}), ("b2", {"interleave": True})):
        ms = {t_len: cuda_ms(lambda: drnmf_scan.drnmf_scan_factored(
            *a, **kwargs), 10) for t_len, a in args.items()}
        per_step = (ms[256] - ms[16]) / 240
        line[name] = {"ms_by_steps": ms, "ms_per_step": per_step,
                      "ms_per_call_besides_steps": ms[16] - 16 * per_step}
    for t_len in (16, 256):
        line["b2"][f"profile_{t_len}_steps"] = profiled(
            lambda: drnmf_scan.drnmf_scan_factored(*args[t_len],
                                                   interleave=True))[0]
    line["b2"]["host_ms_of_the_call_at_16_steps"] = host_ms(
        lambda: drnmf_scan.drnmf_scan_factored(*args[16], interleave=True))
    return line


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}), flush=True)
    libs = build_variants()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cfg, params, rng = _model(0, 257, 1000, 5, "cuda")
    failed = False
    for bsz, t_len in ((256, 1021), (64, 16), (1, 1021)):
        x = torch.from_numpy(
            rng.uniform(0, 1, (bsz, t_len, 257)).astype(np.float32)).cuda()
        args = drnmf.factored_scan_operands(
            params, cfg, x, drnmf.step_mask_from_input(x, cfg.mask_value))
        ni = drnmf_scan.interleaved_batch_tile(bsz, 2000, n_sm)
        other = next(w for w in drnmf_scan.INTERLEAVED_BATCH_TILES
                     if w != ni)
        # (key, build, batch tile, back-projection stretches, one chain)
        runs = [(f"{name}_plan", name, None, None, False) for name in libs]
        runs.append((f"two_ni{other}", "two", other, None, False))
        runs.append(("two_plan_bp8", "two", None, 8, False))
        if bsz > 1:  # at one row chain B is empty in the plan already
            runs += [(f"one_chain_wait1_ni{w}", "two", w, None, True)
                     for w in drnmf_scan.INTERLEAVED_BATCH_TILES]
        line = {"shape": [bsz, t_len], "plan_batch_tile": ni}
        first = {}
        for key, name, tile, bp, one in runs + runs[::-1]:
            out = run(libs[name], args, tile, bp, one)
            entry = line.setdefault(key, {"ms": [], "bits_equal": True,
                                          "bits_equal_to_plan": True})
            # builds at the same tile and stretches must agree
            same = (tile or ni, bp, one)
            first.setdefault(same, out)
            first.setdefault(bp, out)
            entry["bits_equal"] &= bool(torch.equal(out, first[same]))
            entry["bits_equal_to_plan"] &= bool(torch.equal(out, first[bp]))
            entry["ms"].append(cuda_ms(lambda: run(libs[name], args, tile,
                                                   bp, one),
                                       2 if t_len > 100 else 20))
        if bsz == 256:
            line["errors_against_f64"] = errors_against_f64(libs, args)
        print(json.dumps(line), flush=True)
        failed |= not all(v["bits_equal"] for v in line.values()
                          if isinstance(v, dict) and "bits_equal" in v)
    print(json.dumps({"per_call_cost_at_64_rows": per_call_cost(
        params, cfg, rng)}), flush=True)
    if failed:
        sys.exit("a build's output differs from another's at the same tile "
                 "and stretches")


if __name__ == "__main__":
    main()
