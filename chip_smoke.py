#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (drnmf_torch) on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- requires CUDA; prints the card's name and power limit.
2. build   -- builds kernel B1 (ops/csrc/drnmf_scan_factored.cu) with nvcc;
              prints ptxas's register and spill counts.
3. kernel  -- B1 against its plain PyTorch version on the card, at a small
              odd shape and at the flagship widths over 64 steps.
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

Then a line with the kernel table, the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that.
"""

import json
import os
import statistics
import subprocess
import sys
import time

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
    from drnmf_torch.ops import build, drnmf_scan
    from drnmf_torch.train.checkpoint import save_checkpoint
    from drnmf_torch import enhance_wav

    resolve_device("cuda")

    # 2. build
    t0 = time.perf_counter()
    built = build.build(drnmf_scan.SOURCE)
    drnmf_scan._library()
    log("build", seconds=time.perf_counter() - t0, library=str(built.name),
        ptxas=[line.strip() for line in
               build.build_log(drnmf_scan.SOURCE).splitlines()
               if "registers" in line or "spill" in line])

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
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
