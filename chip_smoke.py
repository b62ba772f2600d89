#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (drnmf_torch) on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- requires CUDA; prints the card's name and power limit.
2. build   -- builds kernel B1 (ops/csrc/drnmf_scan_factored.cu) and kernels
              B4/B5 (ops/csrc/snmf_mu.cu) with nvcc, one process each, in
              parallel; prints ptxas's register and spill counts.
3. kernel  -- B1 against its plain PyTorch version on the card, at a small
              odd shape and at the flagship widths over 64 steps.
   snmf_kernel -- B4 and B5 against their plain versions (and one whole MU
              iteration with half of W frozen) at the JAX hold-out shape, at
              odd shapes that cut every tile and at m=257, 2r=2000, n=4,099.
4. main    -- the flagship model (K=5, 2r=2000, F=257; random dictionary from
              seed 7654) through ``python -m drnmf_torch.enhance_wav`` on a
              few synthetic wavs, then ``enhance_signals`` on 256 signals of
              8 s (2 warm-up calls, 3 timed); B1's launch count must rise.
5. parity  -- the whole path against the same path with the recurrence
              forced to the plain version, on 4 signals of 2 s.
6. stages  -- one warm ``enhance_signals`` call of 256 x 8 s, stage by
              stage (its ``lap`` hook, a synchronisation at each stage).
   times   -- B1 and its plain version at the main path's shapes
              (B=256, T=1021), and the end-to-end real-time factor.
7. snmf_recipe -- the dictionary stage through ``train_snmf`` at full width
              (r=1000, 2r=2000, F=257) on 139 x 8 s of synthetic clean and
              noisy frames (139,695 frames: stage 1 in one chunk, stage 2 in
              two), 10 iterations a chunk; B4/B5 launch once per iteration;
              the dictionary then initialises the flagship model, which
              enhances 4 signals through B1.
8. snmf_infer -- ``snmf_infer_irm`` (W frozen, 200 iterations) on 16 x 8 s.
9. snmf_parity -- ``sparse_nmf_ed`` with B4/B5 against the same solver on
              the plain passes, 10 iterations at 257 x 16,080 x 2000.
10. snmf_times -- B4, B5, their plain versions and the bare cuBLAS products
              at bench.py's SNMF shape (257 x 140,000, 2r=2000), and the
              end-to-end ``sparse_nmf`` iteration rate there.

Then a line with the kernel table, the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
FS = 16000
N_FFT, HOP = 512, 128
# B1 against its plain version: f32 on both sides with a different
# summation order (thin products of 257 and 2000 terms, 2K-1 of them per
# step, through the recurrence), so about 1e-6 relative is expected
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# B4/B5 against their plain versions: f32 on both sides, sums of up to
# 140,000 terms in another order; error relative to each output's largest
# entry
SNMF_RTOL = 1e-4
# the dictionary stage: 139 x 8 s of frames (139,695), r=1000 a source
SNMF_SIGNALS, SNMF_R, SNMF_ITERS = 139, 1000, 10
INFER_SIGNALS, INFER_ITERS = 16, 200
SNMF_TIMES_SHAPE = (257, 2000, 140_000)  # bench.py::bench_snmf's m, 2r, n
# whole path: a mask error within the kernel tolerance (<= 1e-4) moves a
# waveform by at most about 2e-4 of its peak (four overlapping frames,
# synthesis scale 0.5): -74 dB, far inside the 0.1 dB SDR budget
WAVE_RTOL_OF_PEAK = 2e-4


def log(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def compare(out, ref):
    """(max abs err, max rel err, within KERNEL_RTOL/ATOL)."""
    diff = (out - ref).abs()
    ok = bool((diff <= KERNEL_ATOL + KERNEL_RTOL * ref.abs()).all())
    rel = (diff / ref.abs().clamp_min(1e-30)).max().item()
    return diff.max().item(), rel, ok


def flagship():
    """bench.py's flagship model: K=5, r=1000, untied and trainable
    log_D/log_alph, unit-norm uniform(0.01, 1) dictionary at seed 7654."""
    import torch
    from drnmf_torch.convert import init_drnmf_params
    from drnmf_torch.models.drnmf import DRNMFConfig

    config = DRNMFConfig(input_dim=257, r=1000, output_dim=257, K_layers=5,
                         alph=400.0, lam1=1.0,
                         params_untied=("log_D", "log_alph"),
                         params_trainable=("log_D", "log_alph"))
    rng = np.random.default_rng(7654)
    w = rng.uniform(0.01, 1.0, (257, 2000)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    params = init_drnmf_params(config, w,
                               generator=torch.Generator().manual_seed(7654),
                               device="cuda")
    return config, params


def scan_operands(config, params, x):
    import torch
    from drnmf_torch.models.drnmf import (factored_scan_operands,
                                          step_mask_from_input)

    x = torch.as_tensor(x, device="cuda")
    return factored_scan_operands(params, config, x,
                                  step_mask_from_input(x, config.mask_value))


def cuda_ms(fn, reps):
    """Mean device ms per call over ``reps`` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def b1_bound(args):
    """(bound ms, 'bytes' or 'operations') of one B1 call on these inputs:
    2*F*2r*(2K-1) flops per valid (unmasked) row-step over the f32 CUDA-core
    peak, against each input read once and the output written once over
    the HBM rate."""
    x, step_mask = args[0], args[1]
    bsz, t_len, f = x.shape
    n2r, k_layers = args[2].shape[-1], args[7].shape[0]
    flops = 2 * f * n2r * (2 * k_layers - 1) * int(step_mask.sum().item())
    nbytes = sum(a.numel() * a.element_size() for a in args)
    nbytes += bsz * t_len * n2r * 4  # output
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def synth_signals(rng, n, seconds):
    """Noise plus a few tones, peak below 1."""
    t = np.arange(int(FS * seconds)) / FS
    sigs = []
    for _ in range(n):
        tones = sum(rng.uniform(0.05, 0.2) * np.sin(
            2 * np.pi * rng.uniform(100, 3000) * t + rng.uniform(0, 6.3))
            for _ in range(3))
        sigs.append((tones + 0.05 * rng.standard_normal(t.size))
                    .astype(np.float32))
    return sigs


def snmf_bounds(m, r, n):
    """{pass: (bound ms, 'bytes' or 'operations')} of one B4 and one B5
    call on these shapes: 6 (B4) or 1 (B5) products of 2*m*r*n flops over
    the f32 CUDA-core peak, against each input read once and each output
    written once over the HBM rate."""
    inputs = 4 * (m * n + r * n + m * r)  # v, h, w
    out = {}
    for name, products, outputs in (("pass1", 6, 4 * (r * n + 2 * m * r + 1)),
                                    ("pass2", 1, 4)):
        t_ops = products * 2 * m * r * n / PEAK_F32_FLOPS
        t_bytes = (inputs + outputs) / PEAK_BYTES_PER_S
        out[name] = (1e3 * max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def snmf_operands(rng, m, r, n):
    """v (m, n), h (r, n) and a unit-column w (m, r) on the card, from a
    numpy generator."""
    import torch

    def uniform(lo, shape):
        return torch.from_numpy(
            rng.uniform(lo, 1.0, shape).astype(np.float32)).cuda()

    w = uniform(0.1, (m, r))
    return (uniform(0.01, (m, n)), uniform(0.1, (r, n)),
            w / (w * w).sum(dim=0, keepdim=True).sqrt())


def snmf_errors(v, h, w, sparsity):
    """B4 and B5 against their plain versions on the same inputs:
    {output: (max abs err, max abs err / max |plain|)}.  These launches do
    not count as the main path's."""
    import torch
    from drnmf_torch.ops import snmf_mu

    out = snmf_mu.snmf_mu_pass1(v, h, w, sparsity)
    ref = snmf_mu.snmf_mu_pass1_reference(v, h, w, sparsity)
    pairs = list(zip(("h_new", "a", "b", "sp_sum"), out, ref))
    pairs.append(("div", snmf_mu.snmf_mu_pass2(v, out[0], w),
                  snmf_mu.snmf_mu_pass2_reference(v, out[0], w)))
    torch.cuda.synchronize()
    errs = {}
    for name, o, rf in pairs:
        diff = (o - rf).abs().max().item()
        errs[name] = (diff, diff / max(rf.abs().max().item(), 1e-30))
    return errs


def snmf_kernel_phase():
    """B4/B5 against their plain versions at shapes that cut every tile,
    and one whole MU iteration with half of W frozen."""
    import torch
    from drnmf_torch.ops import snmf_mu

    rng = np.random.default_rng(11)
    for m, r, n, sparsity in ((17, 6, 40, 0.7), (65, 63, 129, 0.0),
                              (257, 100, 4099, 1.0), (257, 2000, 4099, 1.0)):
        case = f"m{m}_r{r}_n{n}_sp{sparsity}"
        v, h, w = snmf_operands(rng, m, r, n)
        errs = snmf_errors(v, h, w, sparsity)
        w_mask = torch.arange(r, device="cuda") < r // 2
        it = snmf_mu.mu_ed_iteration(v, h, w, sparsity, w_mask)
        plain = snmf_mu.mu_ed_iteration(v, h, w, sparsity, w_mask,
                                        passes=snmf_mu.PLAIN_PASSES)
        for name, o, rf in zip(("iter_h", "iter_w", "iter_div", "iter_cost"),
                               it, plain):
            diff = (o - rf).abs().max().item()
            errs[name] = (diff, diff / rf.abs().max().item())
        if not sparsity:
            errs.pop("sp_sum")  # zero on both sides
        ok = all(rel <= SNMF_RTOL for _, rel in errs.values())
        log("snmf_kernel", case=case, rtol_of_max=SNMF_RTOL, ok=ok,
            max_abs_err={k: e[0] for k, e in errs.items()},
            max_rel_err={k: e[1] for k, e in errs.items()})
        check(ok, f"B4/B5 disagree with their plain versions at {case}")


def iteration_split(v, h, w):
    """Where one warm MU iteration's time goes: device ms by kernel name
    from ``torch.profiler`` (B4's four products and its sums, the W-update
    glue, B5), the sum of device time, and the iteration's wall ms between
    two synchronisations; their difference is the device's idle time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from drnmf_torch.ops import snmf_mu

    w_mask = torch.ones(w.shape[1], dtype=torch.bool, device="cuda")
    snmf_mu.mu_ed_iteration(v, h, w, 1.0, w_mask)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        snmf_mu.mu_ed_iteration(v, h, w, 1.0, w_mask)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            continue  # an operator: its kernels are counted themselves
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        if ms > 0:  # names cut to 100 characters may merge kernels
            prev = kernels.get(e.key[:100], [0.0, 0])
            kernels[e.key[:100]] = [prev[0] + ms, prev[1] + e.count]
    busy = sum(k[0] for k in kernels.values())
    return {"device_ms_by_kernel": dict(sorted(
                kernels.items(), key=lambda kv: -kv[1][0])),
            "device_busy_ms": busy, "wall_ms_profiled": wall_ms,
            # None when the profiler saw no device time (not measured)
            "idle_share": max(0.0, 1.0 - busy / wall_ms) if busy else None}


def synth_frames(gen, n_signals, seconds=8.0):
    """Clean and noisy magnitude frames (F, n_signals * frames) of
    synthetic signals, made on the card: three tones a signal with a slow
    amplitude envelope, plus white noise for the noisy copy; through the
    port's STFT (n_fft 512, hop 128) and the pipeline's frame glue."""
    import torch
    from drnmf_torch.data import masked_seqs_to_frames
    from drnmf_torch.dsp.stft import stft

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    t = torch.arange(int(FS * seconds), device="cuda") / FS
    amp = 0.05 + 0.15 * rand(n_signals, 3, 1)
    freq = 100.0 + 2900.0 * rand(n_signals, 3, 1)
    phase = 6.3 * rand(n_signals, 3, 1)
    env = 0.5 + 0.5 * torch.sin(2 * np.pi * 0.5 * t + phase)
    clean = (amp * env * torch.sin(2 * np.pi * freq * t + phase)).sum(dim=1)
    noise = 0.05 * torch.randn(clean.shape, generator=gen, device="cuda")
    frames = []
    for wav in (clean, clean + noise):
        mag = stft(wav, N_FFT, HOP).abs()  # (B, T, F)
        mask = torch.ones(mag.shape[:2] + (1,), device="cuda")
        frames.append(masked_seqs_to_frames(mag, mask))
    return frames


def snmf_phases(card, config):
    """Phases 7-10; returns the kernel table's rows for B4 and B5."""
    import torch
    from drnmf_torch.config import snmf_params_from_config
    from drnmf_torch.convert import init_drnmf_params
    from drnmf_torch.enhance import enhance_signals
    from drnmf_torch.models import snmf_infer_irm
    from drnmf_torch.ops import drnmf_scan, snmf, snmf_mu
    from drnmf_torch.train import snmf_recipe
    from drnmf_torch.utils.cache import load_snmf, snmf_cache_path

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke", "dicts")
    gen = torch.Generator(device="cuda").manual_seed(2017)

    # 7. the dictionary entry point at full width
    clean, noisy = synth_frames(gen, SNMF_SIGNALS)
    params = snmf_params_from_config({"r": SNMF_R, "lam1": 1.0,
                                      "snmf_max_iter": SNMF_ITERS})
    solve = snmf.sparse_nmf
    iterations = []

    def counted(*args, **kwargs):  # observes the iterations each chunk ran
        res = solve(*args, **kwargs)
        iterations.append(res.n_iter)
        return res

    snmf.sparse_nmf = counted
    drnmf_scan.LAUNCHES = 0
    snmf_mu.LAUNCHES.update(pass1=0, pass2=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        w_noisy, _, obj = snmf_recipe.train_snmf(
            clean, noisy, params, path_dicts=work, flag_recompute=True,
            verbose=False)
    finally:
        snmf.sparse_nmf = solve
    recipe_s = time.perf_counter() - t0
    launches = dict(snmf_mu.LAUNCHES)
    w_clean, _, obj_clean = load_snmf(
        snmf_cache_path(params, work, prefix="clean"), load_h=False)
    norms = np.sqrt((w_noisy.astype(np.float64) ** 2).sum(axis=0))
    speech_diff = float(np.abs(w_noisy[:, :SNMF_R] - w_clean).max())
    check(w_noisy.shape == (257, 2 * SNMF_R) and np.isfinite(w_noisy).all(),
          f"dictionary of shape {w_noisy.shape} or not finite")
    check(np.abs(norms - 1).max() <= 1e-5, "dictionary columns not unit")
    # the frozen speech half is renormalised each iteration, as in the
    # reference, so it may move by a few ulps, no more
    check(speech_diff <= 1e-6, f"speech half moved by {speech_diff}")
    check(obj_clean["cost"][-1] < obj_clean["cost"][0]
          and obj["cost"][-1] < obj["cost"][0], "the cost did not fall")
    check(launches["pass1"] == launches["pass2"] == sum(iterations),
          f"B4/B5 launched {launches} times for {iterations} iterations")
    w_flag = init_drnmf_params(config, w_noisy)
    sigs = synth_signals(np.random.default_rng(4), 4, 8.0)
    enhanced = enhance_signals(w_flag, config, sigs, N_FFT, HOP)
    b1_launches = drnmf_scan.LAUNCHES
    check(all(np.isfinite(e).all() for e in enhanced) and b1_launches == 1,
          "the model from the learned dictionary did not enhance through B1")
    log("snmf_recipe", card=card, frames=[int(clean.shape[1]),
                                          int(noisy.shape[1])],
        chunk_iterations=iterations, launches=launches, seconds=recipe_s,
        clean_cost_first_last=[float(obj_clean["cost"][0]),
                               float(obj_clean["cost"][-1])],
        noisy_cost_initial_final=[float(c) for c in obj["cost"]],
        speech_half_max_abs_diff=speech_diff,
        max_col_norm_err=float(np.abs(norms - 1).max()),
        enhance_b1_launches=b1_launches,
        reduced={"snmf_max_iter": [1000, SNMF_ITERS]})
    del clean

    # 8. SNMF enhancer, W frozen, 200 iterations
    x_frames = noisy[:, :noisy.shape[1] * INFER_SIGNALS // SNMF_SIGNALS]
    x_frames = x_frames.contiguous()
    del noisy
    snmf_mu.LAUNCHES.update(pass1=0, pass2=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    irm, _ = snmf_infer_irm(x_frames, w_noisy, params, max_iter=INFER_ITERS)
    infer_s = time.perf_counter() - t0
    infer_launches = dict(snmf_mu.LAUNCHES)
    check(irm.shape == (257, x_frames.shape[1]) and np.isfinite(irm).all()
          and irm.min() >= 0 and irm.max() <= 1, "mask not finite in [0, 1]")
    check(infer_launches == {"pass1": INFER_ITERS, "pass2": INFER_ITERS},
          f"snmf_infer_irm launched {infer_launches}, expected "
          f"{INFER_ITERS} each")
    log("snmf_infer", card=card, frames=int(x_frames.shape[1]),
        launches=infer_launches, seconds=infer_s,
        irm_min=float(irm.min()), irm_max=float(irm.max()))

    # 9. the solver on the kernels against the solver on the plain passes
    m, r2, n = 257, 2 * SNMF_R, x_frames.shape[1]
    w0 = torch.rand((m, r2), generator=gen, device="cuda")
    h0 = torch.rand((r2, n), generator=gen, device="cuda")
    w_mask = torch.arange(r2, device="cuda") >= r2 // 2
    runs = [snmf_mu.sparse_nmf_ed(x_frames, w0, h0, 1.0, w_mask, 10, 0.0,
                                  passes=passes)
            for passes in (None, snmf_mu.PLAIN_PASSES)]
    (w_k, _, _, costs_k, _), (w_p, _, _, costs_p, _) = runs
    w_err = (w_k - w_p).abs().max().item() / w_p.abs().max().item()
    cost_err = ((costs_k - costs_p).abs() / costs_p.abs()).max().item()
    log("snmf_parity", shape=[m, r2, n], iterations=10, rtol=SNMF_RTOL,
        w_max_rel_err=w_err, cost_max_rel_err=cost_err,
        costs=costs_k.tolist())
    check(w_err <= SNMF_RTOL and cost_err <= SNMF_RTOL,
          "sparse_nmf_ed on the kernels disagrees with the plain passes")
    del runs, w0, h0, x_frames

    # 10. times at bench.py's SNMF shape
    m, r2, n = SNMF_TIMES_SHAPE
    v, h, w = snmf_operands(np.random.default_rng(12), m, r2, n)
    errs = snmf_errors(v, h, w, 1.0)
    check(all(rel <= SNMF_RTOL for _, rel in errs.values()),
          f"B4/B5 disagree with their plain versions at {m}x{n}x{r2}")
    ms = {"pass1": cuda_ms(lambda: snmf_mu.snmf_mu_pass1(v, h, w, 1.0), 5),
          "pass2": cuda_ms(lambda: snmf_mu.snmf_mu_pass2(v, h, w), 5)}
    plain_ms = {
        "pass1": cuda_ms(lambda: snmf_mu.snmf_mu_pass1_reference(v, h, w, 1.0),
                         5),
        "pass2": cuda_ms(lambda: snmf_mu.snmf_mu_pass2_reference(v, h, w),
                         5)}
    lam = (w @ h).clamp_min(1e-9)
    cublas_ms = {
        "pass1": cuda_ms(lambda: (w @ h, w.T @ v, w.T @ lam, w @ h,
                                  v @ h.T, lam @ h.T), 5),
        "pass2": cuda_ms(lambda: w @ h, 5)}
    del lam
    bounds = snmf_bounds(m, r2, n)
    split = iteration_split(v, h, w)
    n_iter = 20
    nmf_params = snmf.SNMFParams(r=r2, cf="ed", sparsity=1.0,
                                 max_iter=n_iter, conv_eps=0.0,
                                 random_seed=2016)
    snmf.sparse_nmf(v, nmf_params, device_output=True)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snmf.sparse_nmf(v, nmf_params, device_output=True)
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - t0) / n_iter
    log("snmf_times", card=card, shape=[m, r2, n], ms=ms, plain_ms=plain_ms,
        cublas_products_ms=cublas_ms,
        bound_ms={k: b[0] for k, b in bounds.items()},
        bound_by={k: b[1] for k, b in bounds.items()},
        max_abs_err={k: e[0] for k, e in errs.items()},
        max_rel_err={k: e[1] for k, e in errs.items()},
        snmf_iters_per_s=1.0 / per_iter,
        seconds_for_1000_iter_dictionary=1000.0 * per_iter,
        iterations_timed=n_iter, iteration_split=split)

    rows = []
    for name, line, outputs in (("pass1", 97, ("h_new", "a", "b", "sp_sum")),
                                ("pass2", 134, ("div",))):
        rows.append({
            "name": f"snmf_mu_{name}",
            "route": "cuda",
            "source": "drnmf_torch/ops/csrc/snmf_mu.cu",
            "replaces": f"drnmf_tpu/ops/pallas/snmf_mu.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(errs[o][0] for o in outputs),
            "ms": ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            "library_ms": None,
        })
    return rows


def main():
    import torch
    import yaml

    # 1. device
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device", card=card, kind=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    from drnmf_torch.device import resolve_device
    from drnmf_torch.dsp.stft import bucket_total, stft_frames
    from drnmf_torch.dsp.wav import wavwrite
    from drnmf_torch.dsp.windows import sqrt_hann_periodic
    from drnmf_torch.enhance import enhance_signals, stage_clock
    from drnmf_torch.models.drnmf import DRNMFConfig
    from drnmf_torch.convert import init_drnmf_params
    from drnmf_torch.ops import build, drnmf_scan, snmf_mu
    from drnmf_torch.train.checkpoint import save_checkpoint
    from drnmf_torch import enhance_wav

    resolve_device("cuda")

    # 2. build, one nvcc per source, all started together
    t0 = time.perf_counter()
    sources = (drnmf_scan.SOURCE, snmf_mu.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(build.build, sources))
    drnmf_scan._library()
    snmf_mu._library()
    for source, lib in zip(sources, built):
        log("build", seconds=time.perf_counter() - t0, library=str(lib.name),
            ptxas=[line.strip() for line in
                   build.build_log(source).splitlines()
                   if "registers" in line or "spill" in line
                   or "Compiling entry" in line])

    # 3. kernel vs plain version
    rng = np.random.default_rng(0)
    f, r, K = 9, 8, 3
    w = rng.uniform(0.05, 1.0, (f, 2 * r)).astype(np.float32)
    w /= np.sqrt(np.sum(w**2, axis=0))
    small_cfg = DRNMFConfig(input_dim=f, r=r, output_dim=f, K_layers=K,
                            alph=10.0, lam1=0.5)
    small_params = init_drnmf_params(
        small_cfg, w, generator=torch.Generator().manual_seed(0), device="cuda")
    x = rng.uniform(0, 1, (3, 11, f)).astype(np.float32)
    x[1, 7:] = small_cfg.mask_value
    config, params = flagship()
    cases = [("small_B3_T11_F9_2r16_K3", small_cfg, small_params, x),
             ("flagship_B256_T64_F257_2r2000_K5", config, params,
              rng.uniform(0, 1, (256, 64, 257)).astype(np.float32))]
    for name, cfg, prm, xin in cases:
        args = scan_operands(cfg, prm, xin)
        out = drnmf_scan.drnmf_scan_factored(*args)
        torch.cuda.synchronize()
        ref = drnmf_scan.drnmf_scan_factored_reference(*args)
        torch.cuda.synchronize()
        err, rel, ok = compare(out, ref)
        log("kernel", case=name, max_abs_err=err, max_rel_err=rel,
            rtol=KERNEL_RTOL, atol=KERNEL_ATOL, ok=ok)
        check(ok, f"B1 disagrees with its plain version at {name}")

    snmf_kernel_phase()

    # 4. main path, through the entry points, at full width
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    os.makedirs(work, exist_ok=True)
    ckpt = os.path.join(work, "model_unfolded_snmf_flagship.npz")
    cfg_path = os.path.join(work, "params_unfolded_snmf_flagship.yaml")
    save_checkpoint(ckpt, params)
    with open(cfg_path, "w") as fh:
        yaml.safe_dump({"K_layers": 5, "r": 1000, "alph": 400.0, "lam1": 1.0,
                        "params_untied": ["log_D", "log_alph"],
                        "params_trainable": ["log_D", "log_alph"]}, fh)
    wavs = []
    for i, s in enumerate(synth_signals(np.random.default_rng(1), 3, 3.0)):
        wavs.append(os.path.join(work, f"noisy{i}.wav"))
        wavwrite(wavs[-1], FS, s[None])
    batch = [s for s in (0.1 * np.random.default_rng(2).standard_normal(
        (256, FS * 8))).astype(np.float32)]

    drnmf_scan.LAUNCHES = 0
    cli_outs = enhance_wav.main(["-c", cfg_path, "-m", ckpt, "-o",
                                 os.path.join(work, "enhanced"), *wavs])
    walls = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = enhance_signals(params, config, batch, N_FFT, HOP,
                               batch_size=256)
        torch.cuda.synchronize()
        if i >= 2:
            walls.append(time.perf_counter() - t0)
    launches = drnmf_scan.LAUNCHES
    check(len(outs) == 256 and all(o.shape == (FS * 8,) for o in outs),
          "enhance_signals returned the wrong shapes")
    check(all(np.isfinite(o).all() for o in outs + cli_outs),
          "non-finite enhanced samples")
    audio_s = 256 * 8.0
    rtf = audio_s / statistics.median(walls)
    log("main", launches_before=0, launches_after=launches,
        rtf=rtf, rtf_runs=[audio_s / w_ for w_ in walls], batch=256,
        seconds_per_signal=8.0, card=card)
    check(launches == 6, f"B1 launched {launches} times on the main path, "
          "expected one per enhance call (6)")

    # 5. whole path vs the all-plain path on the card
    sigs = synth_signals(np.random.default_rng(3), 4, 2.0)
    fast = enhance_signals(params, config, sigs, N_FFT, HOP)
    plain = enhance_signals(params, config, sigs, N_FFT, HOP,
                            scan_fn=drnmf_scan.drnmf_scan_factored_reference)
    diff = max(float(np.abs(a - p).max()) for a, p in zip(fast, plain))
    peak = max(float(np.abs(p).max()) for p in plain)
    log("parity", max_abs_wave_diff=diff, peak=peak,
        tol=WAVE_RTOL_OF_PEAK * peak)
    check(diff <= WAVE_RTOL_OF_PEAK * peak,
          "whole path disagrees with the all-plain path")

    # 6. times at the main path's shapes (B=256, T=1021)
    for _ in range(2):  # the second call is warm
        stages = {}
        enhance_signals(params, config, batch, N_FFT, HOP, batch_size=256,
                        lap=stage_clock(stages, "cuda"))
    log("stages", card=card, seconds=stages,
        seconds_total=sum(stages.values()))
    total = bucket_total(FS * 8, N_FFT, HOP)
    wav = torch.zeros((256, total), device="cuda")
    wav[:, N_FFT:N_FFT + FS * 8] = torch.as_tensor(np.stack(batch),
                                                   device="cuda")
    window = torch.as_tensor(sqrt_hann_periodic(N_FFT), device="cuda")
    with torch.inference_mode():
        mag = stft_frames(wav, window, N_FFT, HOP).abs()
    args = scan_operands(config, params, mag)
    out = drnmf_scan.drnmf_scan_factored(*args)
    ref = drnmf_scan.drnmf_scan_factored_reference(*args)
    torch.cuda.synchronize()
    err, rel, ok = compare(out, ref)
    check(ok, "B1 disagrees with its plain version at the main path's shape")
    del out, ref
    ms = cuda_ms(lambda: drnmf_scan.drnmf_scan_factored(*args), 3)
    plain_ms = cuda_ms(
        lambda: drnmf_scan.drnmf_scan_factored_reference(*args), 3)
    bound_ms, bound_by = b1_bound(args)
    log("times", card=card, shape=list(mag.shape), b1_ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
        max_rel_err=rel, rtf=rtf)

    snmf_rows = snmf_phases(card, config)

    print(json.dumps({"kernels": [{
        "name": "drnmf_scan_factored",
        "route": "cuda",
        "source": "drnmf_torch/ops/csrc/drnmf_scan_factored.cu",
        "replaces": "drnmf_tpu/ops/pallas/drnmf_scan.py:169",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }] + snmf_rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
