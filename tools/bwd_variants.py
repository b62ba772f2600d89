#!/usr/bin/env python3
"""Time the backward kernel of the DR-NMF recurrence
(``drnmf_scan_factored_backward``) in its variants on one NVIDIA GPU: the
record of its tuning.

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit:

    python3 tools/bwd_variants.py

Variants of ``ops/csrc/drnmf_scan_factored_bwd.cu``, each built with the
package's nvcc flags into ``build/drnmf_torch_kernels/``: stripes of W =
16 columns of 2r (the source as it is) with the weights resident in shared
memory (``w16_resident``, what the plan picks on an H100) and streamed
from L2 with each phase's operands (``w16_streamed``), and W = 32 (a copy
of the source with its constant W patched: 63 stripes, half the partials;
its resident bytes do not fit, so streamed). Each runs at the flagship
widths (K=5, 2r=2000, F=257; a random unit-norm dictionary from seed 0,
alph = 2000 so that every layer is active) on the layer stack of B1 with
every layer kept at B x T = 32 x 500 (the training batch) and
1 x 500, in turns (a b c c b a), ms a call from CUDA events. Outputs must
equal bit for bit where W is equal, and every layer must have deltas.
Each variant's deltas, p and gamma must lie within 1e-4 of each output's
largest entry of the plain version run in float64 (chip_smoke.py's
GRAD_RTOL_OF_MAX): with every layer active through 500 steps, f32 routes
that sum in different orders drift apart past the elementwise rtol 1e-4
/ atol 1e-5 of short runs (the plain version's own f32 error against
float64 is printed beside). Prints one JSON line for the
card, one for each build (ptxas's registers and spills by instance) and
one for each shape (each variant's plan, ms a call and us a step, and
where a step's time goes: the per-phase split of one call of a build with
``-DBWD_TRACE``, whose blocks write clock64() at marks of each phase).
"""

import contextlib
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from drnmf_torch.convert import init_drnmf_params  # noqa: E402
from drnmf_torch.models import drnmf  # noqa: E402
from drnmf_torch.ops import build, drnmf_scan  # noqa: E402

RUNS = (("w16", True), ("w16", False), ("w32", False))
# builds: name -> (stripe width W, extra nvcc flags)
BUILDS = {"w16": (16, ()), "w32": (32, ()),
          "w16_trace": (16, ("-DBWD_TRACE",))}
TRACE_STEPS = 9
F64_RTOL_OF_MAX = 1e-4
W_LINE = "constexpr int W = 16;"


def build_variants():
    """{name: (W, ctypes library)} of the stripe widths, built in
    parallel; a width other than the source's from a copy with W
    patched."""
    src = build.CSRC / drnmf_scan.BACKWARD_SOURCE
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = src.read_text()
    if W_LINE not in text:
        sys.exit(f"{src.name} no longer holds {W_LINE!r}")
    procs = {}
    for name, (stripe, flags) in BUILDS.items():
        so = build.BUILD_DIR / f"bwd_variant_{name}.so"
        cu = src
        if stripe != 16:
            cu = build.BUILD_DIR / f"bwd_variant_{name}.cu"
            cu.write_text(text.replace(W_LINE,
                                       f"constexpr int W = {stripe};"))
        procs[name] = stripe, so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", str(so),
             str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (stripe, so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.drnmf_scan_factored_backward.argtypes = ([ptr] * 15 + [i32] * 16
                                                     + [ptr])
        lib.drnmf_scan_factored_backward.restype = i32
        lib.drnmf_scan_factored_backward_capacity.argtypes = [i32] * 3
        lib.drnmf_scan_factored_backward_capacity.restype = i32
        lib.drnmf_scan_factored_backward_smem.argtypes = [i32] * 6
        lib.drnmf_scan_factored_backward_smem.restype = i32
        lib.drnmf_scan_factored_backward_max_smem.argtypes = []
        lib.drnmf_scan_factored_backward_max_smem.restype = i32
        lib.drnmf_cuda_error_string.argtypes = [i32]
        lib.drnmf_cuda_error_string.restype = ctypes.c_char_p
        if "trace" in name:
            lib.drnmf_scan_factored_backward_trace.argtypes = [ptr, i32]
            lib.drnmf_scan_factored_backward_trace.restype = i32
        libs[name] = stripe, lib
        instance, ptxas = None, {}
        for line in log.splitlines():
            if "Compiling entry function" in line:
                instance = line.split("kernelI")[-1].split("EEEv")[0]
            elif instance and ("registers" in line or "spill" in line):
                ptxas.setdefault(instance, []).append(line.strip())
        print(json.dumps({"build": name, "stripe": stripe,
                          "ptxas_by_instance(rows,resident)": ptxas}),
              flush=True)
    return libs


def flagship_model(seed=0):
    """The flagship widths (K=5, r=1000, F=257) with alph = 2000, where
    every layer is active on uniform(0, 1) frames."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.05, 1.0, (257, 2000)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    cfg = drnmf.DRNMFConfig(input_dim=257, r=1000, output_dim=257,
                            K_layers=5, alph=2000.0, lam1=0.5)
    params = init_drnmf_params(cfg, w, device="cuda",
                               generator=torch.Generator().manual_seed(seed))
    return cfg, params, rng


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


def trace_split(variant, back, k_layers):
    """One call of the traced build (the plan's instance) with its marks
    on: for each phase of a step (A, then R_k and P_k from k = K-1), the
    mean over the traced steps after the first of: the work of the
    slowest block and of the mean block (phase start to the grid sync),
    the mean and least wait in the grid sync, and for A and P the mean
    block's wait for its operands, product, epilogue and the rest (the
    rowsums and the back-projection); a step's cycles (block 0); in SM
    cycles (clock64)."""
    use(variant)
    plan = drnmf_scan.drnmf_scan_factored_backward_plan(
        back[2].shape[3], back[6].shape[2], back[6].shape[1], k_layers)
    buf = torch.zeros((TRACE_STEPS, 2 * k_layers - 1, plan.grid, 9),
                      dtype=torch.int64, device="cuda")
    lib = variant[1]
    check_code(lib.drnmf_scan_factored_backward_trace(buf.data_ptr(),
                                                      TRACE_STEPS))
    drnmf_scan.drnmf_scan_factored_backward(*back)
    torch.cuda.synchronize()
    check_code(lib.drnmf_scan_factored_backward_trace(None, 0))
    b = buf[1:].double()
    names = ["A"] + [f"{x}{k}" for k in range(k_layers - 1, 0, -1)
                     for x in ("R", "P")]
    phases = {}
    for ph, name in enumerate(names):
        x = b[:, ph]
        work = x[..., 4] - x[..., 0]
        wait = x[..., 5] - x[..., 4]
        entry = {"work_slowest": work.max(dim=1).values.mean().item(),
                 "work_mean": work.mean().item(),
                 "sync_wait_mean": wait.mean().item(),
                 "sync_wait_least": wait.min(dim=1).values.mean().item()}
        if name[0] != "R":
            for key, (a, c) in (("operands", (0, 1)), ("product", (1, 2)),
                                ("epilogue", (2, 3)), ("rest", (3, 4)),
                                ("bp_sums_thread0", (6, 7)),
                                ("bp_stores_thread0", (7, 8)),
                                ("bp_wait_all", (8, 4))):
                if key.startswith("bp") and not x[..., 6].any():
                    continue  # P_1: no back-projection
                entry[key] = (x[..., c] - x[..., a]).mean().item()
        phases[name] = entry
    step = (b[:, -1, 0, 5] - b[:, 0, 0, 0]).mean().item()
    return {"cycles_a_step": step, "phases": phases}


def check_code(code):
    if code != 0:
        sys.exit(f"the trace entry failed with CUDA error {code}")


def use(variant):
    """Point the wrapper at the (W, library) ``variant``: the plan's W
    follows the build's."""
    drnmf_scan.BACKWARD_STRIPE, lib = variant
    drnmf_scan._backward_library = lambda: lib


def instance(resident):
    """The plan's instance, or the streamed one forced."""
    return (contextlib.nullcontext() if resident
            else drnmf_scan.streamed_backward())


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}), flush=True)
    libs = build_variants()
    stripe, library = drnmf_scan.BACKWARD_STRIPE, drnmf_scan._backward_library
    cfg, params, rng = flagship_model()
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = False
    try:
        for bsz, t_len in ((32, 500), (1, 500)):
            x = torch.from_numpy(rng.uniform(0, 1, (bsz, t_len, 257))
                                 .astype(np.float32)).cuda()
            args = drnmf.factored_scan_operands(
                params, cfg, x, drnmf.step_mask_from_input(x, cfg.mask_value))
            _, h_all = drnmf_scan.drnmf_scan_factored(*args, keep_layers=True)
            g = torch.randn((bsz, t_len, 2000), generator=gen, device="cuda")
            back = (g, args[1], h_all, *args[3:8])
            ref = drnmf_scan.drnmf_scan_factored_backward_reference(*back)
            ref64 = drnmf_scan.drnmf_scan_factored_backward_reference(
                *(a.double() if a.is_floating_point() else a for a in back))

            def of_max(out):
                return [((a - b).abs().max() / b.abs().max()).item()
                        for a, b in zip(out, ref64)]

            line, first = {"shape": [bsz, t_len]}, {}
            line["layers_with_deltas"] = [bool(ref64[0][k].any())
                                          for k in range(5)]
            line["plain_f32_err_of_max_vs_f64"] = of_max(ref)
            for name, resident in RUNS + RUNS[::-1]:
                use(libs[name])
                key = f"{name}_{'resident' if resident else 'streamed'}"
                with instance(resident):
                    plan = drnmf_scan.drnmf_scan_factored_backward_plan(
                        h_all.shape[3], 257, 2000, 5)
                    out = drnmf_scan.drnmf_scan_factored_backward(*back)
                entry = line.setdefault(key, {
                    "plan": plan._asdict(), "ms": [], "bits_equal": True,
                    "max_abs_err_vs_plain_f32": max(
                        (a - b).abs().max().item() for a, b in zip(out, ref)),
                    "err_of_max_vs_f64": of_max(out)})
                entry["within_tolerance"] = max(
                    entry["err_of_max_vs_f64"]) <= F64_RTOL_OF_MAX
                if plan.resident != resident:
                    entry["plan_differs"] = True
                base = first.setdefault(name, out)
                entry["bits_equal"] &= all(torch.equal(a, b)
                                           for a, b in zip(out, base))
                with instance(resident):
                    entry["ms"].append(cuda_ms(
                        lambda: drnmf_scan.drnmf_scan_factored_backward(
                            *back), 3))
                entry["us_per_step"] = [1e3 * ms / t_len for ms in entry["ms"]]
            line["trace_w16_resident"] = trace_split(libs["w16_trace"],
                                                     back, 5)
            print(json.dumps(line), flush=True)
            failed |= not (all(line["layers_with_deltas"]) and all(
                v["bits_equal"] and v["within_tolerance"]
                for v in line.values() if isinstance(v, dict) and "ms" in v))
            del ref, ref64, h_all, back
    finally:
        drnmf_scan.BACKWARD_STRIPE = stripe
        drnmf_scan._backward_library = library
    if failed:
        sys.exit("a variant is past its tolerance against the float64 plain "
                 "version or differs from the other instance of its stripe "
                 "width, or a layer had no deltas")


if __name__ == "__main__":
    main()
