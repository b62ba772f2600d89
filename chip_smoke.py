#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (drnmf_torch) on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one card and the CUDA
toolkit:

    python3 chip_smoke.py

The kernels against their plain versions over grids of shapes are the
card tests (``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py -q``).  This script times the kernels at the
paths' own shapes, keeps only the checks that hold at those shapes, and
drives every path that no benchmark cell runs.  Each bound is the
benchmark's (``benchmark/yardstick/``: one dense TF32 pass or the bytes of
the work the inputs need), beside two ceilings the yardstick does not
count (``bounds_ms``); the frozen SNMF route's bounds are this script's
own count until the yardstick counts that route.

Phases, each printing one JSON line:

1. device  -- requires CUDA; prints the card's name and power limit.
2. build   -- builds kernels B1 (ops/csrc/drnmf_scan_factored.cu), B2
              (ops/csrc/drnmf_scan_factored_interleaved.cu), B3
              (ops/csrc/drnmf_scan_dense.cu), B1's backward
              (ops/csrc/drnmf_scan_factored_bwd.cu) and B4/B5
              (ops/csrc/snmf_mu.cu) with nvcc, one process each, in
              parallel; prints ptxas's register and spill counts.
3. main    -- the flagship model (K=5, 2r=2000, F=257; random dictionary from
              seed 7654) through ``python -m drnmf_torch.enhance_wav`` on a
              few synthetic wavs, then ``enhance_signals`` on 256 signals of
              8 s (2 warm-up calls, 3 timed); B1's launch count must rise.
4. stages  -- one warm ``enhance_signals`` call of 256 x 8 s, stage by
              stage (its ``lap`` hook, a synchronisation at each stage).
   times   -- B1, B2 and their plain version at the main path's shapes
              (B=256, T=1021) and at the streaming shape (64 x 16), B1 and
              B2 at one row (1 x 1021), and the end-to-end real-time factor.
              For each of B1 and B2: its plan and grid syncs a call at each
              shape, ms a step, useful TFLOP/s, its bound beside what three
              TF32 passes and the f32 CUDA cores could reach and the share
              of each (fails above 100% of the first, for B2 also of the
              second), and the step split by layer; B1's cost of one grid
              sync at each shape's grid (a kernel of bare syncs).  At
              256 x 1021, both against the plain version, a bit-equal
              repeat of each; rows 0-63 as a 64-row call and rows 0, 63,
              255 alone equal to the same rows of the 256-row call bit for
              bit (B1) or within the tolerance, bit equality reported (B2);
              B2 against B1 at every shape; B1 and B2 against the plain
              version at 64 x 16 and 1 x 1021 too.
5. dense_main -- a dense-U flagship model (the flagship parameters with
              log_U1/log_Uk perturbed from a seed, so the rank-one fold does
              not hold; U trainable in its YAML) through ``enhance_wav`` and
              ``enhance_signals`` on 8 s signals: B3 launches once per
              enhance call, B1 never.
   dense_times -- B3 and its plain version at that shape and at the
              streaming shape (64 x 16), B3 at one row (1 x 1021); for each
              B3's plan, grid syncs a call, ms a step, useful TFLOP/s, its
              bound (the weights past the L2 counted again every step)
              beside what three TF32 passes and the f32 CUDA cores could
              reach, the share of each (fails above 100% of the first two),
              and the step split by layer; at the main shape B3 against its
              plain version, a bit-equal repeat, rows 0-63 as a 64-row call
              and rows 0, 63, 255 alone against the same rows of the batch
              (bit equality reported, the kernel tolerance held); B3 against
              its plain version at 64 x 16 and 1 x 1021 too.
6. stream  -- ``StreamingEnhancer`` (64-frame blocks) on one 8 s signal fed
              in odd chunks, frozen-U (B1) and dense-U (B3), against
              ``enhance_signals`` on the card.
   multi   -- ``MultiStreamEnhancer``, 64 streams of 16-frame blocks under a
              rotating ``active`` mask, drained with ``flush_stream`` and a
              tail: frozen-U (B1), frozen-U asked for the interleaved entry
              (B2), dense-U (B3); every stream against its offline output.
   serve   -- ``python -m drnmf_torch.serve --streams 4`` (the event-loop
              server) in a thread of this process on 127.0.0.1, four client
              threads sending 3 s each in protocol chunks; replies against
              offline.  Every socket has a timeout.
   paced   -- ``paced_load`` for 5 s at 64 streams; prints ``paced_stats``.
7. train   -- the flagship model through ``drnmf_torch.train.train_model``
              at the reference schedule (B=32, T=500, Adam lr 1e-3) on
              synthetic noisy/clean magnitudes (``synth_magnitudes``, every
              fourth sequence padded past an early end): 2 epochs of 4
              batches and 32 validation sequences; each step launches B1
              (every layer kept) and the backward kernel once (its
              launches by instance, resident or streamed weights, are
              logged), each evaluation B1 once, the time loop never.  Then
              (``train_check``) one batch's gradients against autograd
              through ``drnmf_scan_factored_reference`` (within
              GRAD_RTOL_OF_MAX of each gradient's largest entry) and three
              Adam steps' losses and parameters against the same steps on
              the plain Function (``scan_factored_train_reference``;
              rtol 1e-4, parameters also atol 1e-6); and
              (``train_times``) ms a step (median of 5 after 2), steps/s
              and valid frames/s, one step under ``torch.profiler`` (B1's
              and the backward kernel's device ms, the device's idle
              share), and the forward, the backward kernel (and its plain
              version, its error at this shape) and the weight-gradient
              products each timed alone, each beside its bound (the
              yardstick's ``train_bounds``) and the share of it; the
              backward's plan (instance, W, stripes, grid, shared bytes,
              grid syncs a step), us a step at 32 rows and at one row
              (fails where a share reads over 100%); heads, loss and Adam
              are the profiled device time left.
8. pipeline -- the experiment pipeline through its command line
              (``drnmf_torch.cli.main`` in this process, the test split
              enhanced and, for the flagship, scored) on a synthetic
              corpus under
              build/chip_smoke/pipeline/ (``make_synthetic_corpus``, 96
              files of ``wsj0_like_lengths``, about 700 s of audio, one
              corpus for all three splits), with the configs of
              scripts/run_waspaa2017.py at full width (data_config without
              its HDF5 datafiles: n_fft 512, hop 128, maxlen 500, mag/mag;
              the flagship drnmf_config(5, 1000) cut to 2 epochs and 20
              dictionary iterations a stage): the dictionary (B4/B5), the
              fit (B1 with every layer kept and the backward kernel, once a
              step; B1 once an evaluation) and ``predict_irm`` (B1 once a
              batch of each length bucket), the test split scored (six
              per-SNR score files, the overall row finite, the engine on
              all 96 files), then the same command again, where every
              artifact and score comes from its cache (no scoring, the
              score files untouched) and only ``predict_irm``'s B1
              launches, and once more with ``--rescore`` (the same
              launches, all 96 rows scored again, the overall row within
              SCORE_TOLS of the first; bit equality printed); every
              enhanced wav there,
              finite, of its noisy file's length rounded up to the hop; 4
              test files against ``enhance_signals`` with the same best
              checkpoint (PIPE_WAV_RTOL/ATOL); snmf_config(1000) (the
              dictionary from the cache, 200 inference iterations: B4/B5
              only) and lstm_config(5, 250) for 1 epoch (no kernel); and
              the flagship fit stopped after epoch 1 by
              ``DRNMF_TRAIN_DEADLINE_TS``, then resumed, against the
              uninterrupted fit (PIPE_RESUME_RTOL_OF_MAX).  Prints the
              stage seconds (``StageTimer``), the dictionary's seconds, the
              train ms a step (evaluations and checkpoints included), the
              real-time factor of predict plus reconstruct, the scoring
              RTF, the overall scores, the launches by run and the LSTM's
              ms a step.
9. score  -- ``metrics.engine.score_all_packed`` on the card (int16
              buffers, align "guard", PESQ on), one line for each of (a)
              the pipeline's enhanced test split (96 files, read as PCM16
              by the native reader), (a') the same files' noisy input
              against the same references and (b) bench.py::bench_score's
              battery (64 PCM16 AM sinusoids of 2-5 s, seed 7, built here
              by its recipe): a first call (cuFFT's plan cache cleared
              first) and SCORE_TIMED_CALLS warm calls (the scoring RTF,
              audio seconds per wall second, of each), the buckets, a
              repeat bit-equal or not, the same engine with
              ``device="cpu"`` held column by column (SCORE_TOLS; (b) not
              in SDR, whose near-periodic references need the ridge
              escalation; a NaN on one side only fails), the rows
              escalated at each ridge on either device (SDR at every
              ridge, ``engine.sdr_at_ridges``), delays equal to the CPU's;
              for (a) and (a') PESQ against the float64 host model and
              STOI against the per-file path on 8 files; device ms by
              kernel group (FFTs, Cholesky, gathers) and the idle share of
              one warm call (``profiled``), and the device ms of the
              parts of one bucket's pass (``score_ops``: the FFT of the
              rows, the SDR, the factorization alone, the delay, PESQ and
              its smoothing loop, STOI and its segment gather).
10. snmf_recipe -- the dictionary stage through ``train_snmf`` at full width
              (r=1000, 2r=2000, F=257) on 139 x 8 s of synthetic clean and
              noisy frames (139,695 frames: stage 1 in one chunk, stage 2 in
              two), 10 iterations a chunk; B4/B5 launch once per iteration;
              the dictionary then initialises the flagship model, which
              enhances 4 signals through B1.
11. snmf_infer -- ``snmf_infer_irm`` (W frozen, 200 iterations, the
              frozen route: one B4 and one B5 launch an iteration) on
              16 x 8 s.
12. snmf_parity -- ``sparse_nmf_ed`` with B4/B5 against the same solver on
              the plain passes, 10 iterations at 257 x 16,080 x 2000: half
              of W frozen (the general route), then all of it (the frozen
              route).
13. snmf_times -- B4, B5, their plain versions and the bare cuBLAS products
              at bench.py's SNMF shape (257 x 140,000, 2r=2000): ms, useful
              TFLOP/s, the bound beside what three TF32 passes and the f32
              CUDA cores could reach, B4/B5 against their plain versions (sums
              over 140,000 frames) and a bit-equal repeat of both, the frozen
              route's passes bit-equal to the general ones, their times at
              the recipe's unpadded 139,695 frames, one iteration split by
              kernel, and the end-to-end ``sparse_nmf`` iteration rate; the
              frozen route's passes each timed beside its bound, and one
              iteration of it (W^T v and lam carried over) beside the
              general route's and beside its bound, split by kernel.
14. parallel -- the multi-rank paths (``drnmf_torch.parallel``): two ranks
              of one gloo group sharing the card (``run_ranks``; NCCL
              refuses two ranks of one communicator on one device), every
              collective with a timeout.  (a) ``parallel_fit``: the flagship
              through ``train_model`` at B=32, T=500 for PAR_STEPS steps and
              PAR_VALID_SEQS validation sequences, alone (this process),
              data parallel (16 rows a rank: B1 with every layer kept and
              the backward kernel on each rank's rows), FSDP (each rank's
              parameter and moment bytes equal to ``plan_memory``) and
              tensor parallel (dp=1 x tp=2, ``drnmf_apply_tp_dp``, no
              kernel); losses and parameters against the one process
              (PAR_FIT_RTOL / PAR_FIT_ATOL), ms a step, one step's
              collectives by axis (count, bytes and ms, the device
              synchronised around each).  (b) ``sparse_nmf_sharded`` at
              SNMF_TIMES_SHAPE for PAR_SNMF_ITERS iterations (B4/B5 on each
              rank's frames) against one process on the same inputs
              (SNMF_RTOL of each output's largest entry), ms an iteration
              of both.  (c) ``score_all_sharded`` of the pipeline's test
              split against ``score_all_packed`` (delays equal,
              ``hold_scores`` with each row's ridges from the batch its
              rank scored it in), the Scoring RTF of a warm call.  (d) the
              CLI as a user runs it: ``--dp 2`` and ``--dp 2 --fsdp`` at
              the flagship on the pipeline's corpus (1 epoch; the overall
              scores against one process's, SDR at
              ILL_CONDITIONED_SDR_TOL), ``--dp 2 --tp 2`` on its first
              files (2 steps; the losses against one process's), the
              layout and backend line of each, and ``--tp 2`` on the LSTM
              refused.
15. pipelined -- the pipelined recurrences at the flagship widths, ranks of
              one gloo group sharing the card (``Mesh.shift`` stages each
              carry through pinned host memory).  ``seqpipe``: SEQ_RANKS
              ranks, B=64, T=1020 (noisy magnitudes, every fourth row
              padded past an early end), G = 2 and 4 groups, frozen U
              (B1, G launches a call on each rank) and dense U (B3);
              ``layerpipe``: K = 5 ranks, B=10, T=32, folded and dense U
              (no kernel).  Each against one process's ``make_scan`` on
              the same input (KERNEL_RTOL/ATOL; bit equality logged), one
              warm-up and SEQ_CALLS timed calls beside one process's
              call, the bytes staged and the collectives by rank.  Then
              the five ranks each write their FSDP block of the flagship
              parameters (``save_checkpoint_sharded``), and this process
              loads them whole, bit-equal.
16. tooling -- (a) the pipeline phase's cached CLI rerun alone, with
              ``--trace`` and with ``--dp 2 --trace``: each trace file
              parses, holds the ``StageTimer`` stage names, and rank 0's
              holds B1's kernel symbol (rank 0 alone predicts in a cached
              run); seconds and bytes beside the untraced run, and the
              three runs' launches (B1 must rise).  (b)
              ``run_waspaa2017.main`` with the pipeline's data YAML,
              ``--demo --demo-epochs 1 --only 2,10`` (SNMF r=1000, then
              DR-NMF K=5 r=1000 from its dictionary, both splits scored):
              B4, B5, B1 and the backward kernel launch, counted from 0
              just before it; then
              ``print_scores`` (plain, ``--per-snr``) and
              ``plot_learning_curves`` (its text output where matplotlib
              is absent) on that folder; ``create_taskfiles`` on a
              CHiME2-shaped tree of links to the corpus, each list equal
              to its links.  (c) ``ista_ed`` at 257 x 2000 x 4096, 5
              steps, against the CPU; B1 with every layer kept, one step,
              32 rows, on the flagship at alph 2000 (every layer active)
              with log_Uk at -80: layers 1..K-1 each one ISTA step from
              the layer below (KERNEL_RTOL of the peak + KERNEL_ATOL).
              (d) where h5py is installed, the flagship written as a
              Keras HDF5, imported with ``import_reference_weights`` and
              4 signals enhanced, bit-equal to the original parameters;
              where it is not, a line ``{"phase": "tooling", "h5py":
              false}``.

Every path is driven with all launch counts set to 0 just before it and
read just after.

Then a line with the kernel table (B1 to B5 and the backward kernel; the
launches by path include ``parallel`` and ``pipelined``, summed over the
ranks, and ``tooling``), the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that.
"""

import dataclasses
import functools
import json
import os
import pickle
import socket
import statistics
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark.yardstick import bounds as yardstick
from benchmark.yardstick import dense_bounds as yardstick_dense
from benchmark.yardstick import trace
from benchmark.yardstick.peaks import PEAK_BYTES_PER_S, PEAK_TF32_FLOPS

# H100 SXM f32 peak on the CUDA cores (NVIDIA data sheet); the yardstick
# keeps the dense TF32 and HBM3 peaks
PEAK_F32_FLOPS = 67e12
FS = 16000
N_FFT, HOP = 512, 128
# B1 against its plain version: f32 on both sides with a different
# summation order (thin products of 257 and 2000 terms, 2K-1 of them per
# step, through the recurrence), so about 1e-6 relative is expected
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# B4/B5 against their plain versions: f32 on one side, three TF32 products
# a term on the other (the dropped tail product is 2^-22 of a term; the
# tensor cores sum short chains only, which are added in f32 on the CUDA
# cores), sums of up to 140,000 terms in another order: a few 1e-6 is
# expected; error relative to each output's largest entry
SNMF_RTOL = 1e-4
# the dictionary stage: 139 x 8 s of frames (139,695), r=1000 a source
SNMF_SIGNALS, SNMF_R, SNMF_ITERS = 139, 1000, 10
INFER_SIGNALS, INFER_ITERS = 16, 200
SNMF_TIMES_SHAPE = (257, 2000, 140_000)  # bench.py::bench_snmf's m, 2r, n
# streaming against offline on the card: the same kernels on the same rows
# (their per-row arithmetic does not depend on the batch), so what differs
# is cuFFT's batching and the overlap-add's order (a block's frames first,
# the carry after): f32 rounding of the waveform
STREAM_RTOL, STREAM_ATOL = 1e-4, 1e-5
STREAMS, MULTI_BLOCK = 64, 16  # the server's default block (serve.py)
SOCKET_TIMEOUT_S = 120.0
# a profiled window (``profiled``) spans calls for at least PROFILE_S; the
# profiler's session stays open PROFILE_GRACE_S past it
PROFILE_S, PROFILE_GRACE_S = 1.0, 0.2
# training at the reference schedule (BASELINE.md, "Train maxlen" and
# "DR-NMF training": Adam lr 1e-3, clipnorm 0, batch 32, 500 frames a
# sequence), cut to 2 epochs of 4 batches and 32 validation sequences
TRAIN_BATCH, TRAIN_T, TRAIN_BATCHES, VALID_SEQS, TRAIN_EPOCHS = (
    32, 500, 4, 32, 2)
TRAIN_LR = 1e-3
# gradients through the kernels against those through the plain versions
# (f32 both sides, sums in other orders, through 500 steps): relative to
# each gradient's largest entry
GRAD_RTOL_OF_MAX = 1e-4
# ... and, where every layer is active (alph = 2000), against float64: the
# f32 plain route itself is 6.4e-4 off there (relu decisions near zero and
# 500 steps of the gamma chain), so 1e-3
GRAD_RTOL_VS_F64 = 1e-3
# the experiment pipeline at the flagship width: the configs of
# scripts/run_waspaa2017.py (data_config without the HDF5 datafiles,
# drnmf_config(5, 1000), snmf_config(1000), lstm_config(5, 250)), cut to 2
# epochs (the LSTM 1), 20 dictionary iterations a stage, on a synthetic
# corpus of 96 WSJ0-like lengths (about 690 s of audio) used for all three
# splits; only the test split is enhanced
PIPE_FILES, PIPE_SEED, PIPE_EPOCHS, PIPE_SNMF_ITERS = 96, 2016, 2, 20
PIPE_DATA = {"downsample": 1, "maxlen": 500,
             "params_stft": {"N": N_FFT, "hop": HOP, "nch": 1},
             "transform_x": "mag", "transform_y": "mag"}
PIPE_DRNMF = {"K_layers": 5, "r": 1000, "alph": 400.0, "lam1": 1.0,
              "batch_size": 32, "clipnorm": 0.0, "epochs": PIPE_EPOCHS,
              "learning_rate": 1e-3, "loss": "mse_of_masked",
              "optimizer": "adam", "params_trainable": ["log_D", "log_alph"],
              "params_untied": ["log_D", "log_alph"], "patience": 50,
              "snmf_max_iter": PIPE_SNMF_ITERS, "snmf_conv_eps": 1e-4}
PIPE_SNMF = {"r": 1000, "lam1": 1.0, "cf": "ed",
             "snmf_max_iter": PIPE_SNMF_ITERS, "snmf_conv_eps": 1e-4,
             "infer_max_iter": 200, "random_seed": 2016}
PIPE_LSTM = {"K_layers": 5, "hidden_dim": 250, "batch_size": 32,
             "clipnorm": 1.0, "epochs": 1, "learning_rate": 1e-4,
             "loss": "mse_of_masked", "optimizer": "adam", "patience": 50}
# the pipeline's wav against enhance_signals on the card: the same kernels
# on the same frames, sums batched otherwise (rtol 1e-4 / atol 1e-5, the
# streaming tolerance), plus one step of the wav's int16 (1/32768), which a
# difference of 1e-5 can flip
PIPE_WAV_RTOL, PIPE_WAV_ATOL = 1e-4, 1e-5 + 1.0 / 32768
# a resumed fit against the uninterrupted one: relative to each parameter's
# largest entry (the same kernels in the same order: equal but for cuBLAS)
PIPE_RESUME_RTOL_OF_MAX = 1e-6
# the scoring engine on the card against the same engine on the CPU (SDR,
# SNR, SegSNR local, SegSNR global in dB; PESQ in MOS; STOI): the port's
# tolerances against the JAX package (tests/test_torch_metrics.py), f32 on
# both sides with FFTs and Cholesky factorizations from other libraries.
# The SDR solves a 512 x 512 Toeplitz system of the reference's
# autocorrelation r in float32.  A float32 Cholesky factorization's
# backward error may reach n eps r[0] (3e-5 of r[0] at n = 512), so where
# the system's smallest eigenvalue is below 1e-4 of r[0]
# (ILL_CONDITIONED, from a float64 eigensolve on the host) its weak
# directions are set by roundoff: cuSOLVER and LAPACK then disagree at
# the same ridge (8.8e-3 dB on an H100 against the CPU, the pipeline's
# noisy test split) and on whether the first ridge factors at all.  Such rows are held to
# 0.05 dB (the tests' tolerance against the float64 oracle, half the
# 0.1 dB budget) and counted, every other row to 1e-3 dB.  Where the two
# devices kept different ridges, the SDRs are held at every ridge where
# both are finite
ILL_CONDITIONED = 1e-4
ILL_CONDITIONED_SDR_TOL = 0.05
SCORE_TOLS = (1e-3, 1e-3, 1e-3, 1e-3, 2e-3, 1e-3)
SCORE_TIMED_CALLS = 3
# bench.py::bench_score's battery: 64 PCM16 pairs of 2-5 s, seed 7
BENCH_SCORE_FILES, BENCH_SCORE_SEED = 64, 7
# the parallel phase: PAR_RANKS ranks of one gloo group sharing the card;
# the flagship fit at the reference schedule (B=32, T=500) for PAR_STEPS
# steps and PAR_VALID_SEQS validation sequences in each layout, held to
# the single process at the JAX package's dp/FSDP tolerance
# (tests/test_parallel.py: rtol 1e-4, parameters atol 1e-6); sparse NMF
# at SNMF_TIMES_SHAPE for PAR_SNMF_ITERS iterations (its W, H and costs
# within SNMF_RTOL of each one's largest entry of the single process)
PAR_RANKS, PAR_STEPS, PAR_VALID_SEQS, PAR_SNMF_ITERS = 2, 3, 8, 10
PAR_FIT_RTOL, PAR_FIT_ATOL = 1e-4, 1e-6
# a collective that waits longer than this fails the run; the group's
# join has twice as long
PAR_TIMEOUT_S = 300.0
# the CLI's --dp 2 --tp 2 run trains on the pipeline corpus's first files
# up to about this many sequences of 500 frames: 2 steps at B=32
PAR_TP_SEQS = 48
# the pipelined scans (phase ``pipelined``), ranks of one gloo group sharing
# the card: the sequence-pipelined scan over SEQ_RANKS ranks at B=64,
# T=1020 in G = 2 and 4 groups (1 warm-up and SEQ_CALLS timed calls);
# the layer-pipelined scan over K = 5 ranks at B=10, T=32 (T cut: a wave
# is five plain layer steps and one host-staged shift, T G + P - 1 = 164
# waves a call)
SEQ_RANKS, SEQ_BATCH, SEQ_T, SEQ_GROUPS, SEQ_CALLS = 2, 64, 1020, (2, 4), 2
LAYER_BATCH, LAYER_T = 10, 32
# B1's kernel symbol, as a trace names the card's kernels
B1_SYMBOL = "drnmf_scan_factored_kernel"


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


def live_flagship(config, params):
    """The flagship model with alph = 2000 in every layer (log_alph set as
    ``init_drnmf_params`` sets it).  At the flagship's alph = 400 the
    positive random dictionary makes every ISTA layer overshoot: layers 1
    and 3 are zero at every unit and step, so no gradient reaches below the
    top layer.  At 2000 every layer is partly active (63-100% of units on
    uniform(0, 1) frames), so a check of the backward sees every layer."""
    import torch

    live = dict(params)
    for name in config.untied_names("log_alph"):
        live[name] = torch.full_like(params[name],
                                     float(np.log(np.float32(1e-7 + 2000.0))))
    return dataclasses.replace(config, alph=2000.0), live


def dense_flagship(config, params):
    """The flagship model with dense U: log_U1 and log_Uk perturbed downward
    from seed 4567 (U's entries shrink by factors in [0.82, 1] and [0.61, 1],
    so the recurrence stays as stable as the frozen model's), which breaks
    the structure the rank-one fold reads, and both marked trainable as a
    model that trained them would be."""
    import torch
    from drnmf_torch.models.drnmf import fold_structure_holds, u_is_foldable

    rng = np.random.default_rng(4567)
    dense_params = dict(params)
    for name, width in (("log_U1", 0.2), ("log_Uk", 0.5)):
        shift = rng.uniform(0.0, width, tuple(params[name].shape))
        dense_params[name] = params[name] - torch.from_numpy(
            shift.astype(np.float32)).cuda()
    dense_config = dataclasses.replace(
        config, params_trainable=config.params_trainable + ("log_U1",
                                                            "log_Uk"))
    check(not fold_structure_holds(dense_params)
          and not u_is_foldable(dense_config),
          "the dense-U model still folds")
    return dense_config, dense_params


def scan_operands(config, params, x):
    """The recurrence's operands for this model and input on the card, as
    the model's route builds them: B1/B2's for a folded model, B3's for a
    dense-U one."""
    import torch
    from drnmf_torch.models.drnmf import (dense_scan_operands,
                                          factored_scan_operands,
                                          step_mask_from_input, u_is_foldable)

    x = torch.as_tensor(x, device="cuda")
    build_operands = (factored_scan_operands if u_is_foldable(config)
                      else dense_scan_operands)
    return build_operands(params, config, x,
                          step_mask_from_input(x, config.mask_value))


def reset_launches():
    """Set every kernel's launch count to 0 (just before a path is driven)."""
    from drnmf_torch.ops import drnmf_scan, snmf_mu

    for counts in (drnmf_scan.LAUNCHES, drnmf_scan.BACKWARD_INSTANCES,
                   snmf_mu.LAUNCHES):
        for name in counts:
            counts[name] = 0


def read_launches():
    """Every kernel's launch count since the last reset: B1 ``factored``,
    B2 ``interleaved``, B3 ``dense``, B4 ``pass1``, B5 ``pass2``."""
    from drnmf_torch.ops import drnmf_scan, snmf_mu

    return {**drnmf_scan.LAUNCHES, **snmf_mu.LAUNCHES}


def only_launched(launches, *names):
    """True when the kernels ``names`` were launched and no other was."""
    return all((launches[k] > 0) == (k in names) for k in launches)


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


def bounds_ms(entry):
    """A yardstick entry (``flops``, ``bytes``, ``bound_s``, ``bound_by``:
    one dense TF32 tensor-core pass or the bytes at the HBM rate) in
    milliseconds, with the two ceilings the yardstick does not count:
    ``bound_3xtf32_ms``, three TF32 passes a term (the price of the
    f32-class accuracy of B2 to B5), and ``bound_f32_cuda_cores_ms``, the
    f32 rate of the CUDA cores (B1's arithmetic)."""
    t_bytes = entry["bytes"] / PEAK_BYTES_PER_S
    return {"flops": entry["flops"], "bytes": entry["bytes"],
            "bound_ms": 1e3 * entry["bound_s"], "bound_by": entry["bound_by"],
            "bound_3xtf32_ms": 1e3 * max(3 * entry["flops"] / PEAK_TF32_FLOPS,
                                         t_bytes),
            "bound_f32_cuda_cores_ms": 1e3 * max(
                entry["flops"] / PEAK_F32_FLOPS, t_bytes)}


def scan_sizes(args):
    """(rows, steps, valid row-steps, F, 2r, K) of the recurrence's
    operands: sizes from the tensors, the valid (unmasked) row-steps from
    the step mask."""
    rows, steps, f = args[0].shape
    return (rows, steps, int(args[1].sum().item()), f, args[2].shape[-1],
            args[-1].shape[0])


def train_parts(args, n_trainable):
    """``bounds_ms`` of the parts of one train step on B1's operands
    ``args`` (the yardstick's ``train_bounds``: forward, backward,
    weight_grads, heads_loss_adam)."""
    rows, steps, valid, f, n2r, k = scan_sizes(args)
    return {part: bounds_ms(entry) for part, entry in yardstick.train_bounds(
        rows, steps, f, n2r, k, valid, n_trainable).items()}


def factored_call_bounds(args):
    """``bounds_ms`` of one B1 or B2 call on these operands (they compute
    the same function): the yardstick's ``factored_bounds``."""
    rows, _, valid, f, n2r, k = scan_sizes(args)
    return bounds_ms(yardstick.factored_bounds(rows, valid, f, n2r, k))


def dense_call_bounds(args):
    """``bounds_ms`` of one B3 call on these operands: the yardstick's
    ``dense_bounds``."""
    return bounds_ms(yardstick_dense.dense_bounds(*scan_sizes(args)))


BOUND_KEYS = ("bound_ms", "bound_by", "bound_3xtf32_ms",
              "bound_f32_cuda_cores_ms")


def shares(bounds, ms):
    """The share of each bound that ``ms`` a call reaches."""
    return {"share_of_bound": bounds["bound_ms"] / ms,
            "share_of_3xtf32_bound": bounds["bound_3xtf32_ms"] / ms,
            "share_of_f32_cuda_cores_bound":
                bounds["bound_f32_cuda_cores_ms"] / ms}


def b3_plan(bsz, f, n2r):
    """B3's plan for this batch and width on this card."""
    from drnmf_torch.ops import drnmf_scan

    capacity = drnmf_scan._dense_library().drnmf_scan_dense_capacity(
        drnmf_scan.dense_batch_tile(bsz))
    return drnmf_scan.dense_scan_plan(bsz, f, n2r, capacity)


def b3_plan_and_rates(args, ms):
    """B3's plan on these inputs, its grid syncs a call (two a layer), ms a
    step, useful TFLOP/s, its bounds and the share of each at ``ms`` a
    call; and the split of a step by layer: B3 on the same inputs cut to
    the first layer and to two layers, whose difference is one later layer
    (its products over h, hid and x_t, its sums, two syncs)."""
    from drnmf_torch.ops import drnmf_scan

    bsz, t_len, f = args[0].shape
    n2r, k_layers = args[2].shape[-1], args[6].shape[0]
    bounds = dense_call_bounds(args)

    def first_layers(k):
        cut = list(args)
        cut[5] = args[5][:max(1, k - 1)]  # S (a dummy layer when k == 1)
        cut[6], cut[7] = args[6][:k], args[7][:k]  # W, b
        return cut

    reps = 2 if t_len > 100 else 20
    k1, k2 = (cuda_ms(lambda a=first_layers(k): drnmf_scan
                      .drnmf_scan_dense(*a), reps) for k in (1, 2))
    return {"plan": b3_plan(bsz, f, n2r)._asdict(),
            "syncs_per_call": 2 * k_layers * t_len, "ms": ms,
            "ms_per_step": ms / t_len,
            "useful_tflops": bounds["flops"] / ms / 1e9,
            **{key: bounds[key] for key in BOUND_KEYS + ("bytes",)},
            "weight_bytes": yardstick_dense.dense_weight_bytes(f, n2r,
                                                               k_layers),
            **shares(bounds, ms),
            "ms_per_step_first_layer": k1 / t_len,
            "ms_per_step_each_later_layer": (k2 - k1) / t_len}


def factored_layer_split(args, **kwargs):
    """ms a step of B1 (B2 with ``interleave=True``) on these inputs cut to
    the first layer and to two layers, whose difference is one later
    layer (BP, R, P and their three syncs)."""
    from drnmf_torch.ops import drnmf_scan

    def first_layers(k):
        cut = list(args)
        cut[6] = args[6][:max(1, k - 1)]  # dkT (a dummy layer when k == 1)
        cut[7], cut[8] = args[7][:k], args[8][:k]  # dka, b
        return cut

    t_len = args[0].shape[1]
    reps = 2 if t_len > 100 else 20
    k1, k2 = (cuda_ms(lambda a=first_layers(k): drnmf_scan
                      .drnmf_scan_factored(*a, **kwargs), reps)
              for k in (1, 2))
    return {"ms_per_step_first_layer": k1 / t_len,
            "ms_per_step_each_later_layer": (k2 - k1) / t_len}


def b1_plan_and_rates(args, ms):
    """B1's plan on these inputs, its grid syncs a call, ms a step, useful
    TFLOP/s, its bounds and the share of each at ``ms`` a call; the time
    of one grid sync at its grid (a cooperative kernel of bare syncs, as
    many as the call makes, timed after a warm-up); and the split of a
    step by layer (``factored_layer_split``)."""
    import torch
    from drnmf_torch.ops import drnmf_scan

    bsz, t_len, f = args[0].shape
    n2r, k_layers = args[2].shape[-1], args[7].shape[0]
    lib = drnmf_scan._library()
    plan = drnmf_scan.factored_scan_plan(
        bsz, f, n2r, torch.cuda.get_device_properties(0).multi_processor_count,
        lib.drnmf_scan_factored_capacity(drnmf_scan.row_tile(bsz)))
    syncs = 1 + t_len * (1 + 3 * (k_layers - 1))
    stream = torch.cuda.current_stream().cuda_stream
    codes = []
    sync_ms = cuda_ms(lambda: codes.append(
        lib.drnmf_grid_sync_probe(syncs, plan.grid, stream)), 3)
    check(not any(codes), f"the grid-sync probe failed: {codes}")
    bounds = factored_call_bounds(args)
    return {"plan": plan._asdict(), "syncs_per_call": syncs, "ms": ms,
            "ms_per_step": ms / t_len,
            "useful_tflops": bounds["flops"] / ms / 1e9,
            **{key: bounds[key] for key in BOUND_KEYS}, **shares(bounds, ms),
            "us_per_grid_sync": 1e3 * sync_ms / syncs,
            "grid_syncs_ms_per_call": sync_ms,
            **factored_layer_split(args)}


def b2_plan(bsz, f, n2r):
    """B2's plan for this batch and width on this card."""
    import torch
    from drnmf_torch.ops import drnmf_scan

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    capacity = drnmf_scan._interleaved_library(
    ).drnmf_scan_factored_interleaved_capacity(
        drnmf_scan.interleaved_batch_tile(bsz, n2r, n_sm))
    return drnmf_scan.interleaved_scan_plan(bsz, f, n2r, n_sm, capacity)


def b2_plan_and_rates(args, ms):
    """B2's plan on these inputs, its grid syncs a call (one before the
    scan; P_0, then BP, R and P a later layer), ms a step, useful
    TFLOP/s, its bounds and the share of each at ``ms`` a call, and the
    split of a step by layer (``factored_layer_split``)."""
    bsz, t_len, f = args[0].shape
    n2r, k_layers = args[2].shape[-1], args[7].shape[0]
    plan = b2_plan(bsz, f, n2r)
    per_step = 1 + 3 * (k_layers - 1)
    bounds = factored_call_bounds(args)
    return {"plan": plan._asdict(), "syncs_per_call": 1 + t_len * per_step,
            "ms": ms, "ms_per_step": ms / t_len,
            "useful_tflops": bounds["flops"] / ms / 1e9,
            **{key: bounds[key] for key in BOUND_KEYS}, **shares(bounds, ms),
            **factored_layer_split(args, interleave=True)}


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


def close_to(got, want):
    """(max abs difference, within STREAM_RTOL/ATOL) of a streamed waveform
    against the offline one over the offline one's length."""
    got = np.asarray(got)[:len(want)]
    if len(got) < len(want):
        return float("inf"), False
    diff = np.abs(got - want)
    return (float(diff.max()) if diff.size else 0.0,
            bool((diff <= STREAM_ATOL + STREAM_RTOL * np.abs(want)).all()))


def frozen_snmf_bounds(m, r, n):
    """``bounds_ms`` of the frozen SNMF route on (m, r, n): one B4
    (``frozen_pass1``) and one B5 (``frozen_pass2``) call, one product of
    2*m*r*n flops each, and a whole iteration (``frozen_iter``, both);
    each input read once and each output written once.  This script's own
    count until the yardstick counts the route (ROADMAP G.9: its
    ``snmf_bounds`` charges B4 six products an iteration)."""
    return {name: bounds_ms(yardstick.bounds_of(
        products * 2 * m * r * n, yardstick.F32 * words))
        for name, products, words in (
            # h, W^T v, lam and W in; h' and a sum out
            ("frozen_pass1", 1, 3 * r * n + m * n + m * r + 1),
            # h, v and W in; lam and a sum out
            ("frozen_pass2", 1, r * n + 2 * m * n + m * r + 1),
            # B4's W^T lam and B5's W h': h, W^T v, lam, v and W in; h',
            # lam and two sums out
            ("frozen_iter", 2, 3 * r * n + 3 * m * n + m * r + 2))}


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


def profiled(fn, top=10):
    """Warm calls of ``fn`` under ``torch.profiler``, repeated for at least
    PROFILE_S inside a ``trace.WINDOW`` range that ends in a
    synchronisation, reduced by the yardstick's ``trace.summarize`` and
    divided by the calls: (``calls``, ``window_s``, ``busy_s`` (None where
    no device operation was traced: not measured), ``idle_share`` and the
    ``top`` largest ``device_ops`` and ``idle_gaps`` as [name, seconds a
    call]; every device operation of all the calls in the window as
    (start_us, end_us, name), for ``trace.device_seconds``).

    The profiler's device timestamps drift from its host clock as a
    process ages (about 1e-4 on an H100: 4 ms later after 48 s), and it
    drops the device operations past the end of its session: a window of
    one call of a few ms lost every kernel a few minutes into this script.
    So the window spans many calls, and the session stays open
    PROFILE_GRACE_S past it; what the drift still shifts past the window's
    end (a few ms of PROFILE_S) is not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    calls = max(1, int(np.ceil(PROFILE_S / (time.perf_counter() - t0))))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        time.sleep(PROFILE_GRACE_S)
    summary = trace.summarize(prof.events(), top)
    device = summary.pop("device")
    busy, window = summary["busy_s"], summary["window_s"]
    summary.update(
        calls=calls, window_s=window / calls,
        busy_s=None if busy is None else busy / calls,
        idle_share=None if busy is None else 1.0 - busy / window,
        **{key: [[name, s / calls] for name, s in summary[key]]
           for key in ("device_ops", "idle_gaps")})
    return summary, device


def synth_magnitudes(gen, n_signals, seconds=8.0):
    """Clean and noisy magnitude spectrograms (n_signals, T, F) of
    synthetic signals, made on the card: three tones a signal with a slow
    amplitude envelope, plus white noise for the noisy copy; through the
    port's STFT (n_fft 512, hop 128)."""
    import torch
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
    return [stft(wav, N_FFT, HOP).abs() for wav in (clean, clean + noise)]


def synth_frames(gen, n_signals, seconds=8.0):
    """Clean and noisy magnitude frames (F, n_signals * frames) of
    ``synth_magnitudes``' signals, through the pipeline's frame glue."""
    import torch
    from drnmf_torch.data import masked_seqs_to_frames

    frames = []
    for mag in synth_magnitudes(gen, n_signals, seconds):
        mask = torch.ones(mag.shape[:2] + (1,), device="cuda")
        frames.append(masked_seqs_to_frames(mag, mask))
    return frames


def snmf_phases(card, config):
    """Phases 10-13; returns the kernel table's rows for B4 and B5."""
    import torch
    from drnmf_torch.config import snmf_params_from_config
    from drnmf_torch.convert import init_drnmf_params
    from drnmf_torch.enhance import enhance_signals
    from drnmf_torch.models import snmf_infer_irm
    from drnmf_torch.ops import snmf, snmf_mu
    from drnmf_torch.train import snmf_recipe
    from drnmf_torch.utils.cache import load_snmf, snmf_cache_path

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke", "dicts")
    gen = torch.Generator(device="cuda").manual_seed(2017)

    # 10. the dictionary entry point at full width
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
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        w_noisy, _, obj = snmf_recipe.train_snmf(
            clean, noisy, params, path_dicts=work, flag_recompute=True,
            verbose=False)
    finally:
        snmf.sparse_nmf = solve
    recipe_s = time.perf_counter() - t0
    launches = read_launches()
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
    b1_launches = read_launches()["factored"]
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

    # 11. SNMF enhancer, W frozen, 200 iterations
    x_frames = noisy[:, :noisy.shape[1] * INFER_SIGNALS // SNMF_SIGNALS]
    x_frames = x_frames.contiguous()
    del noisy
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    irm, _ = snmf_infer_irm(x_frames, w_noisy, params, max_iter=INFER_ITERS)
    infer_s = time.perf_counter() - t0
    infer_launches = {k: read_launches()[k] for k in ("pass1", "pass2")}
    check(irm.shape == (257, x_frames.shape[1]) and np.isfinite(irm).all()
          and irm.min() >= 0 and irm.max() <= 1, "mask not finite in [0, 1]")
    check(infer_launches == {"pass1": INFER_ITERS, "pass2": INFER_ITERS},
          f"snmf_infer_irm launched {infer_launches}, expected "
          f"{INFER_ITERS} each")
    log("snmf_infer", card=card, frames=int(x_frames.shape[1]),
        launches=infer_launches, seconds=infer_s,
        irm_min=float(irm.min()), irm_max=float(irm.max()))

    # 12. the solver on the kernels against the solver on the plain passes
    m, r2, n = 257, 2 * SNMF_R, x_frames.shape[1]
    w0 = torch.rand((m, r2), generator=gen, device="cuda")
    h0 = torch.rand((r2, n), generator=gen, device="cuda")
    parity = {}
    for route, w_mask in (
            ("general", torch.arange(r2, device="cuda") >= r2 // 2),
            ("frozen", torch.zeros(r2, dtype=torch.bool, device="cuda"))):
        runs = [snmf_mu.sparse_nmf_ed(x_frames, w0, h0, 1.0, w_mask, 10, 0.0,
                                      passes=passes)
                for passes in (None, snmf_mu.PLAIN_PASSES)]
        (w_k, h_k, _, costs_k, _), (w_p, h_p, _, costs_p, _) = runs
        parity[route] = {
            "w_max_rel_err":
                (w_k - w_p).abs().max().item() / w_p.abs().max().item(),
            "h_max_rel_err":
                (h_k - h_p).abs().max().item() / h_p.abs().max().item(),
            "cost_max_rel_err":
                ((costs_k - costs_p).abs() / costs_p.abs()).max().item(),
            "costs": costs_k.tolist()}
    log("snmf_parity", shape=[m, r2, n], iterations=10, rtol=SNMF_RTOL,
        **parity["general"], frozen_route=parity["frozen"])
    check(all(p[k] <= SNMF_RTOL for p in parity.values()
              for k in ("w_max_rel_err", "h_max_rel_err", "cost_max_rel_err")),
          "sparse_nmf_ed on the kernels disagrees with the plain passes")
    del runs, w0, h0, x_frames

    # 13. times at bench.py's SNMF shape
    m, r2, n = SNMF_TIMES_SHAPE
    v, h, w = snmf_operands(np.random.default_rng(12), m, r2, n)
    # B4/B5 against their plain versions with sums over 140,000 frames (the
    # card tests' reach 4,099), relative to each output's largest entry
    first = (*snmf_mu.snmf_mu_pass1(v, h, w, 1.0),
             snmf_mu.snmf_mu_pass2(v, h, w))
    plain = (*snmf_mu.snmf_mu_pass1_reference(v, h, w, 1.0),
             snmf_mu.snmf_mu_pass2_reference(v, h, w))
    errs = {}
    for name, a, b in zip(("h_new", "a", "b", "sp_sum", "div"), first, plain):
        diff = (a - b).abs().max().item()
        errs[name] = (diff, diff / max(b.abs().max().item(), 1e-30))
    del plain
    check(all(rel <= SNMF_RTOL for _, rel in errs.values()),
          f"B4/B5 disagree with their plain versions at {m}x{n}x{r2}")
    # no float atomics, every sum in a fixed order: a repeat is bit-equal,
    # and the frozen route's passes, which read the same products in the
    # same order, equal the general ones
    again = (*snmf_mu.snmf_mu_pass1(v, h, w, 1.0),
             snmf_mu.snmf_mu_pass2(v, h, w))
    repeat_equal = all(torch.equal(a, b) for a, b in zip(first, again))
    check(repeat_equal, f"a repeat of B4/B5 at {m}x{n}x{r2} is not bit-equal")
    state = snmf_mu.FrozenW()
    snmf_mu.snmf_mu_frozen_init(v, h, w, state)
    h_frozen, sp_frozen = snmf_mu.snmf_mu_frozen_pass1(h, 1.0, state)
    frozen_equal = (torch.equal(h_frozen, first[0])
                    and torch.equal(sp_frozen, first[3])
                    and torch.equal(
                        snmf_mu.snmf_mu_frozen_pass2(v, h_frozen, state),
                        snmf_mu.snmf_mu_pass2(v, h_frozen, w)))
    check(frozen_equal, "the frozen route's passes differ from the general "
          f"ones at {m}x{n}x{r2}")
    del first, again, state, h_frozen
    ms = {"pass1": cuda_ms(lambda: snmf_mu.snmf_mu_pass1(v, h, w, 1.0), 5),
          "pass2": cuda_ms(lambda: snmf_mu.snmf_mu_pass2(v, h, w), 5)}
    plain_ms = {
        "pass1": cuda_ms(lambda: snmf_mu.snmf_mu_pass1_reference(v, h, w, 1.0),
                         5),
        "pass2": cuda_ms(lambda: snmf_mu.snmf_mu_pass2_reference(v, h, w),
                         5)}
    # the recipe's frame count handed straight to the kernels: rows of h
    # that do not start on 16 bytes take the narrow copies (the solver pads
    # its frames to a multiple of four for that reason)
    n_odd = SNMF_SIGNALS * 1005
    v_odd, h_odd = v[:, :n_odd].contiguous(), h[:, :n_odd].contiguous()
    unpadded_ms = {
        "pass1": cuda_ms(lambda: snmf_mu.snmf_mu_pass1(v_odd, h_odd, w, 1.0),
                         3),
        "pass2": cuda_ms(lambda: snmf_mu.snmf_mu_pass2(v_odd, h_odd, w), 3)}
    del v_odd, h_odd
    lam = (w @ h).clamp_min(1e-9)
    cublas_ms = {
        "pass1": cuda_ms(lambda: (w @ h, w.T @ v, w.T @ lam, w @ h,
                                  v @ h.T, lam @ h.T), 5),
        "pass2": cuda_ms(lambda: w @ h, 5)}
    del lam
    bounds = {**{k: bounds_ms(e)
                 for k, e in yardstick.snmf_bounds(m, r2, n).items()},
              **frozen_snmf_bounds(m, r2, n)}
    # one warm MU iteration: B4's four products and its sums, the W-update
    # glue, B5
    all_w = torch.ones(r2, dtype=torch.bool, device="cuda")
    split, _ = profiled(lambda: snmf_mu.mu_ed_iteration(v, h, w, 1.0, all_w))
    # the frozen route's iteration, W^T v and lam already in its state (as
    # in every iteration of a solve but the first), beside the general one
    none_w = torch.zeros(r2, dtype=torch.bool, device="cuda")
    state, h_cur = snmf_mu.FrozenW(), [h]

    def frozen_iteration():
        h_cur[0] = snmf_mu.mu_ed_iteration(v, h_cur[0], w, 1.0, none_w, None,
                                           False, None, state)[0]

    frozen_iteration()
    iteration_ms = {
        "general": cuda_ms(
            lambda: snmf_mu.mu_ed_iteration(v, h, w, 1.0, all_w, None, True),
            5),
        "frozen": cuda_ms(frozen_iteration, 5)}
    frozen_split, _ = profiled(frozen_iteration)
    # each frozen pass alone, on the h the state holds (B4 leaves it so,
    # B5 moves it to that same h)
    frozen_ms = {
        "pass1": cuda_ms(
            lambda: snmf_mu.snmf_mu_frozen_pass1(h_cur[0], 1.0, state), 5),
        "pass2": cuda_ms(
            lambda: snmf_mu.snmf_mu_frozen_pass2(v, h_cur[0], state), 5)}
    del state, h_cur
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
    # no share of a peak may read over 100%
    check(all(ms[k] >= bounds[k]["bound_ms"]
              and frozen_ms[k] >= bounds[f"frozen_{k}"]["bound_ms"]
              for k in ms)
          and iteration_ms["frozen"] >= bounds["frozen_iter"]["bound_ms"],
          f"a kernel is faster than its bound: {ms}, {frozen_ms}, "
          f"{iteration_ms} against {bounds}")
    log("snmf_times", card=card, shape=[m, r2, n], ms=ms, plain_ms=plain_ms,
        cublas_products_ms=cublas_ms,
        useful_tflops={k: bounds[k]["flops"] / ms[k] / 1e9 for k in ms},
        **{key: {k: b[key] for k, b in bounds.items()} for key in BOUND_KEYS},
        share_of_bound={k: bounds[k]["bound_ms"] / ms[k] for k in ms},
        share_of_3xtf32_bound={k: bounds[k]["bound_3xtf32_ms"] / ms[k]
                               for k in ms},
        repeat_bit_equal=repeat_equal,
        ms_unpadded_frames={"frames": n_odd, **unpadded_ms},
        max_abs_err={k: e[0] for k, e in errs.items()},
        max_rel_err={k: e[1] for k, e in errs.items()},
        snmf_iters_per_s=1.0 / per_iter,
        seconds_for_1000_iter_dictionary=1000.0 * per_iter,
        iterations_timed=n_iter, iteration_split=split,
        frozen_ms=frozen_ms,
        frozen_share_of_bound={
            k: bounds[f"frozen_{k}"]["bound_ms"] / frozen_ms[k]
            for k in frozen_ms},
        frozen_bit_equal_to_general=frozen_equal, iteration_ms=iteration_ms,
        frozen_iteration_bound={
            k: bounds["frozen_iter"][k]
            for k in ("flops", "bound_ms", "bound_by", "bound_3xtf32_ms")},
        frozen_iteration_share_of_bound=(
            bounds["frozen_iter"]["bound_ms"] / iteration_ms["frozen"]),
        frozen_iteration_split=frozen_split)

    rows = []
    for name, line, outputs in (
            ("pass1", 97, ("h_new", "a", "b", "sp_sum")),
            ("pass2", 134, ("div",))):
        frozen_bound = bounds[f"frozen_{name}"]
        rows.append({
            "name": f"snmf_mu_{name}",
            "route": "cuda",
            "source": "drnmf_torch/ops/csrc/snmf_mu.cu",
            "replaces": f"drnmf_tpu/ops/pallas/snmf_mu.py:{line}",
            "launches": launches[name],
            # the general route's; main adds the paths that run both
            "launches_by_path": {"snmf_recipe": launches[name]},
            "max_abs_err": max(errs[o][0] for o in outputs),
            "ms": ms[name],
            "plain_ms": plain_ms[name],
            **{key: bounds[name][key] for key in BOUND_KEYS},
            # B5 is one product and an elementwise sum; no single call
            # computes B4
            "library_ms": cublas_ms[name] if name == "pass2" else None,
            # the same kernel through its frozen-W wrapper, all that
            # snmf_infer launches (W^T v and the first lam once a solve,
            # in snmf_mu_frozen_init, counted as no launch)
            "frozen_route": {
                "wrapper": f"snmf_mu_frozen_{name}",
                "launches_by_path": {"snmf_infer": infer_launches[name]},
                "bit_equal_to_general": frozen_equal,
                "ms": frozen_ms[name],
                "bound_ms": frozen_bound["bound_ms"],
                "bound_by": frozen_bound["bound_by"],
                "share_of_bound": frozen_bound["bound_ms"] / frozen_ms[name]},
        })
    return rows


def save_model(work, name, config, params):
    """Checkpoint and YAML of a model under ``work``; returns their paths."""
    import yaml
    from drnmf_torch.train.checkpoint import save_checkpoint

    ckpt = os.path.join(work, f"model_unfolded_snmf_{name}.npz")
    cfg_path = os.path.join(work, f"params_unfolded_snmf_{name}.yaml")
    save_checkpoint(ckpt, params)
    with open(cfg_path, "w") as fh:
        yaml.safe_dump({"K_layers": config.K_layers, "r": config.r,
                        "alph": config.alph, "lam1": config.lam1,
                        "params_untied": list(config.params_untied),
                        "params_trainable": list(config.params_trainable)},
                       fh)
    return cfg_path, ckpt


def enhance_main(phase, card, config, params, cfg_path, ckpt, wavs, batch,
                 kernel, n_calls, n_warm):
    """Drive the offline entry points: ``enhance_wav.main`` on the wavs, then
    ``enhance_signals`` on ``batch`` ``n_calls`` times (the first ``n_warm``
    not timed).  ``kernel`` must launch once per enhance call and no other
    kernel at all.  Returns (launches, rtf)."""
    import torch
    from drnmf_torch import enhance_wav
    from drnmf_torch.enhance import enhance_signals

    reset_launches()
    cli_outs = enhance_wav.main(["-c", cfg_path, "-m", ckpt, "-o",
                                 os.path.join(os.path.dirname(ckpt),
                                              f"enhanced_{phase}"), *wavs])
    walls = []
    for i in range(n_calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = enhance_signals(params, config, batch, N_FFT, HOP,
                               batch_size=len(batch))
        torch.cuda.synchronize()
        if i >= n_warm:
            walls.append(time.perf_counter() - t0)
    launches = read_launches()
    check(len(outs) == len(batch)
          and all(o.shape == s.shape for o, s in zip(outs, batch)),
          "enhance_signals returned the wrong shapes")
    check(all(np.isfinite(o).all() for o in outs + cli_outs),
          "non-finite enhanced samples")
    audio_s = sum(len(s) for s in batch) / FS
    rtf = audio_s / statistics.median(walls)
    log(phase, launches=launches, rtf=rtf,
        rtf_runs=[audio_s / w_ for w_ in walls], batch=len(batch),
        seconds_per_signal=len(batch[0]) / FS, calls=n_calls,
        calls_timed=n_calls - n_warm, card=card)
    check(launches[kernel] == 1 + n_calls and only_launched(launches, kernel),
          f"{phase}: launches {launches}, expected {1 + n_calls} of {kernel} "
          "(one per enhance call) and none of another kernel")
    return launches, rtf


def main_path_magnitudes(batch):
    """The magnitude frames (B, T, F) the enhancer hands the recurrence for
    this batch of equal-length signals."""
    import torch
    from drnmf_torch.dsp.stft import bucket_total, stft_frames
    from drnmf_torch.dsp.windows import sqrt_hann_periodic

    n = len(batch[0])
    wav = torch.zeros((len(batch), bucket_total(n, N_FFT, HOP)), device="cuda")
    wav[:, N_FFT:N_FFT + n] = torch.as_tensor(np.stack(batch), device="cuda")
    window = torch.as_tensor(sqrt_hann_periodic(N_FFT), device="cuda")
    with torch.inference_mode():
        return stft_frames(wav, window, N_FFT, HOP).abs()


def stream_phase(card, kind, config, params, kernel):
    """One stream through ``StreamingEnhancer`` in odd chunks against the
    offline enhancer on the card."""
    import torch
    from drnmf_torch.enhance import enhance_signals
    from drnmf_torch.streaming import StreamingEnhancer

    block = 64
    (sig,) = synth_signals(np.random.default_rng(5), 1, 8.0)
    offline = enhance_signals(params, config, [sig], N_FFT, HOP)[0]
    reset_launches()
    enh = StreamingEnhancer(params, config, N_FFT, HOP, block_frames=block)
    enh.process(np.zeros(enh.latency_samples, np.float32))  # warm-up block
    enh.reset()
    warm = read_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [enh.process(sig[i:i + 7001]) for i in range(0, len(sig), 7001)]
    outs.append(enh.flush())
    wall = time.perf_counter() - t0
    launches = read_launches()
    got = np.concatenate(outs)
    diff, ok = close_to(got, offline)
    blocks = launches[kernel] - warm[kernel]
    log("stream", model=kind, kernel=kernel, launches=launches, blocks=blocks,
        block_frames=block, chunk_samples=7001, seconds_of_audio=8.0,
        wall_s=wall, ms_per_block=1e3 * wall / max(blocks, 1),
        rtf=8.0 / wall, max_abs_diff_to_offline=diff,
        peak=float(np.abs(offline).max()), rtol=STREAM_RTOL,
        atol=STREAM_ATOL, ok=ok, card=card)
    check(ok and len(got) == -(-len(sig) // HOP) * HOP
          and np.isfinite(got).all(),
          f"stream ({kind}): StreamingEnhancer disagrees with offline")
    # 8 s are 1,000 hops: 16 blocks of 64 frames, the last one partly padding
    check(blocks >= len(sig) // (block * HOP)
          and only_launched(launches, kernel),
          f"stream ({kind}): launches {launches}, expected {kernel} alone")


def multi_phase(card, kind, config, params, kernel, seconds, scan_fn=None):
    """64 streams in lockstep through ``MultiStreamEnhancer`` under a
    rotating ``active`` mask (one stream in eight sits a round out), each
    drained with ``flush_stream`` and its tail; every stream against its
    offline output.  Returns the phase's launches."""
    import torch
    from drnmf_torch.enhance import enhance_signals
    from drnmf_torch.streaming import MultiStreamEnhancer

    blk = MULTI_BLOCK * HOP
    rng = np.random.default_rng(8)
    # lengths differ, so streams end in different rounds with other tails
    sigs = [(0.1 * rng.standard_normal(int(FS * seconds) - 37 * s))
            .astype(np.float32) for s in range(STREAMS)]
    offline = enhance_signals(params, config, sigs, N_FFT, HOP,
                              batch_size=STREAMS)
    reset_launches()
    multi = MultiStreamEnhancer(params, config, STREAMS, N_FFT, HOP,
                                MULTI_BLOCK, scan_fn=scan_fn)
    multi.step(np.zeros((STREAMS, blk), np.float32))  # warm-up step
    multi.flush_stream(0, tail=np.zeros(HOP, np.float32))
    for s in range(1, STREAMS):
        multi.reset_stream(s)
    warm = read_launches()
    outs = [[] for _ in sigs]
    fed = np.zeros(STREAMS, np.int64)
    step_ms, audio_s, rnd = [], 0.0, 0
    torch.cuda.synchronize()
    t_loop = time.perf_counter()
    while True:
        left = np.array([(fed[s] + 1) * blk <= len(sigs[s])
                         for s in range(STREAMS)])
        if not left.any():
            break
        active = left & ((rnd + np.arange(STREAMS)) % 8 != 0)
        rnd += 1
        if not active.any():
            continue
        samples = np.zeros((STREAMS, blk), np.float32)
        for s in np.nonzero(active)[0]:
            samples[s] = sigs[s][fed[s] * blk:(fed[s] + 1) * blk]
        fed += active
        t0 = time.perf_counter()
        handle = multi.step_dispatch(samples, active)
        finals = multi.step_fetch(handle)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        audio_s += active.sum() * blk / FS
        for s, y in enumerate(finals):
            check((y is None) == (not active[s]),
                  f"multi ({kind}): stream {s} active={active[s]} got {y}")
            if y is not None:
                outs[s].append(y)
    loop_s = time.perf_counter() - t_loop
    steps_launches = read_launches()
    t0 = time.perf_counter()
    for s in range(STREAMS):
        outs[s].append(multi.flush_stream(s, tail=sigs[s][fed[s] * blk:]))
    flush_s = time.perf_counter() - t0
    launches = read_launches()
    # one all-active step under the profiler, after the counts were read
    zeros = np.zeros((STREAMS, blk), np.float32)
    split, device = profiled(lambda: multi.step(zeros), top=6)
    # without the recurrence kernel in the trace (``profiled``), the idle
    # share says nothing
    symbol = {"factored": "drnmf_scan_factored_kernel",
              "interleaved": "drnmf_scan_factored_interleaved_kernel",
              "dense": "drnmf_scan_dense_kernel"}[kernel]
    split["recurrence_kernel_traced"] = any(symbol in n for _, _, n in device)
    if not split["recurrence_kernel_traced"]:
        split["idle_share"] = None  # not measured
    worst, all_ok = 0.0, True
    for s in range(STREAMS):
        got = np.concatenate(outs[s])
        diff, ok = close_to(got, offline[s])
        worst = max(worst, diff)
        all_ok &= (ok and len(got) == -(-len(sigs[s]) // HOP) * HOP
                   and bool(np.isfinite(got).all()))
    median_ms = statistics.median(step_ms)
    if split["idle_share"] is not None:
        # against the unprofiled step: the profiler slows the host side
        split["idle_share_of_median_step"] = max(
            0.0, 1.0 - 1e3 * split["busy_s"] / median_ms)
    log("multi", model=kind, kernel=kernel, launches=launches,
        streams=STREAMS, block_frames=MULTI_BLOCK, seconds_per_stream=seconds,
        steps=len(step_ms), ms_per_step_median=median_ms,
        ms_per_step_mean=statistics.fmean(step_ms),
        ms_per_step_max=max(step_ms),
        aggregate_rtf=audio_s / loop_s,
        aggregate_rtf_all_active=STREAMS * blk / FS / (median_ms / 1e3),
        flush_s_for_all_streams=flush_s, max_abs_diff_to_offline=worst,
        rtol=STREAM_RTOL, atol=STREAM_ATOL, ok=all_ok, step_split=split,
        card=card)
    check(all_ok, f"multi ({kind}): a stream disagrees with its offline output")
    check(steps_launches[kernel] - warm[kernel] == len(step_ms)
          and only_launched(launches, kernel),
          f"multi ({kind}): launches {launches} over {len(step_ms)} steps, "
          f"expected one of {kernel} a step and no other kernel")
    return launches


def serve_phase(card, config, params, cfg_path, ckpt):
    """The event-loop server through ``serve.main`` in a thread of this
    process; four clients at once, each against its offline output."""
    from drnmf_torch import serve
    from drnmf_torch.enhance import enhance_signals

    n_clients, chunk = 4, 4000
    sigs = synth_signals(np.random.default_rng(9), n_clients, 3.0)
    offline = enhance_signals(params, config, sigs, N_FFT, HOP)
    with socket.socket() as probe:  # a free port for the server to bind
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    failures, results = [], [None] * n_clients

    def run_server():
        try:
            serve.main(["-c", cfg_path, "-m", ckpt, "--port", str(port),
                        "--streams", str(n_clients), "--max-connections",
                        str(n_clients), "--block-frames", str(MULTI_BLOCK)])
        except (Exception, SystemExit) as e:  # reported by the check below
            failures.append(("server", repr(e)))

    def recv_reply(sock):
        (m,) = struct.unpack("<i", serve._recv_exact(sock, 4))
        return np.frombuffer(serve._recv_exact(sock, 4 * m), dtype="<f4")

    def run_client(c):
        try:
            deadline = time.monotonic() + SOCKET_TIMEOUT_S
            while True:  # the server listens once its warm-up is done
                try:
                    sock = socket.create_connection(("127.0.0.1", port),
                                                    timeout=SOCKET_TIMEOUT_S)
                    break
                except ConnectionRefusedError:
                    if failures or time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
            with sock:
                outs = []
                for i in range(0, len(sigs[c]), chunk):
                    part = sigs[c][i:i + chunk]
                    sock.sendall(struct.pack("<i", part.size) + part.tobytes())
                    outs.append(recv_reply(sock))
                sock.sendall(struct.pack("<i", 0))  # flush request
                outs.append(recv_reply(sock))
            results[c] = np.concatenate(outs)
        except Exception as e:  # reported by the check below
            failures.append((f"client {c}", repr(e)))

    reset_launches()
    server = threading.Thread(target=run_server, daemon=True)
    clients = [threading.Thread(target=run_client, args=(c,), daemon=True)
               for c in range(n_clients)]
    t0 = time.perf_counter()
    server.start()
    for th in clients:
        th.start()
    for th in clients + [server]:
        th.join(timeout=2 * SOCKET_TIMEOUT_S)
    wall = time.perf_counter() - t0
    launches = read_launches()
    check(not failures and not server.is_alive()
          and not any(th.is_alive() for th in clients),
          f"serve: {failures or 'a thread did not finish'}")
    worst, all_ok = 0.0, True
    for c in range(n_clients):
        diff, ok = close_to(results[c], offline[c])
        worst, all_ok = max(worst, diff), all_ok and ok
    log("serve", server="SelectorStreamServer", clients=n_clients,
        seconds_per_client=3.0, chunk_samples=chunk, launches=launches,
        wall_s_with_start_up=wall, max_abs_diff_to_offline=worst,
        rtol=STREAM_RTOL, atol=STREAM_ATOL, ok=all_ok, card=card)
    check(all_ok, "serve: a client's replies disagree with offline")
    check(only_launched(launches, "factored"),
          f"serve: launches {launches}, expected B1 alone")
    return launches


def paced_phase(card, config, params):
    """``paced_load`` at 64 streams for 5 s: a statistic, not a gate, except
    that it must finish."""
    from drnmf_torch.streaming import (MultiStreamEnhancer, paced_load,
                                       paced_stats)

    reset_launches()
    multi = MultiStreamEnhancer(params, config, STREAMS, N_FFT, HOP,
                                MULTI_BLOCK)
    lat, taken = paced_load(multi, seconds=5.0, fs=FS)
    launches = read_launches()
    stats = paced_stats(lat, multi.block_samples / FS)
    log("paced", streams=STREAMS, block_frames=MULTI_BLOCK, seconds=5.0,
        blocks_per_stream=int(taken.min()), launches=launches, card=card,
        **stats)
    check(int(taken.min()) == int(taken.max()) > 0
          and only_launched(launches, "factored"),
          f"paced: blocks taken {taken.tolist()}, launches {launches}")
    return launches


def train_sequences(gen, n, config):
    """(x, y, mask (n, T, 1)) numpy: noisy and clean magnitudes of n
    synthetic 4 s signals (``synth_magnitudes``) cut to TRAIN_T frames;
    every fourth sequence ends early, at frame 300 + (37 i mod 200), and
    its tail holds the mask value with mask 0, as a padded utterance's
    does."""
    import torch

    clean, noisy = synth_magnitudes(gen, n, TRAIN_T * HOP / FS)
    y = clean[:, :TRAIN_T].contiguous()
    x = noisy[:, :TRAIN_T].contiguous()
    mask = torch.ones((n, TRAIN_T, 1), device="cuda")
    for i in range(0, n, 4):
        end = 300 + (37 * i) % 200
        x[i, end:] = config.mask_value
        y[i, end:] = config.mask_value
        mask[i, end:] = 0
    return tuple(a.cpu().numpy() for a in (x, y, mask))


def train_phase(card, config, params):
    """Phase ``train`` (module docstring).  Returns (the fit's launches,
    the kernel table's row of the backward kernel)."""
    import types

    import torch
    from drnmf_torch.models import batched_grad, drnmf
    from drnmf_torch.ops import drnmf_scan
    from drnmf_torch.train import (TrainConfig, load_checkpoint,
                                   make_optimizer, make_train_step,
                                   masked_mse_signal_approx, train_model)

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke", "train")
    os.makedirs(work, exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(2018)
    train = train_sequences(gen, TRAIN_BATCHES * TRAIN_BATCH, config)
    valid = train_sequences(gen, VALID_SEQS, config)
    trains = drnmf.drnmf_trainable_mask(config, params)
    names = sorted(k for k in params if trains[k])
    n_trainable = sum(params[k].numel() for k in names)

    def loss_fn(scan_fn=None):
        def loss(p, x, y, mask):
            irm = drnmf.drnmf_forward(p, config, x, scan_fn=scan_fn)
            return masked_mse_signal_approx(irm, x, y, mask)
        return loss

    tc = TrainConfig(epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH,
                     learning_rate=TRAIN_LR, clipnorm=0.0, patience=50,
                     verbose=False)
    savefile = os.path.join(work, "model_unfolded_snmf_trained.npz")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, hist = train_model(params, loss_fn(), train, valid, tc,
                             trainable_mask=trains, savefile=savefile,
                             histfile=os.path.join(work, "history.pkl"))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    instances = dict(drnmf_scan.BACKWARD_INSTANCES)
    steps = TRAIN_EPOCHS * TRAIN_BATCHES
    evals = TRAIN_EPOCHS  # one batch of up to 250 validation sequences
    epochs = hist.history["on_epoch_end"]
    saved, meta = load_checkpoint(savefile)
    log("train", card=card, launches=launches,
        backward_launches_by_instance=instances, fit_seconds=fit_s,
        steps=steps, batch=TRAIN_BATCH, frames_a_sequence=TRAIN_T,
        epoch_loss=epochs["loss"], val_loss=epochs["val_loss"],
        batch_loss=hist.history["on_batch_end"]["loss"],
        checkpoint_val_loss=float(meta["val_loss"]))
    check(launches["factored"] == steps + evals
          and launches["factored_backward"] == steps
          and only_launched(launches, "factored", "factored_backward"),
          f"train: launches {launches}, expected {steps} of the backward "
          f"kernel and {steps + evals} of B1 (one a step, one an "
          "evaluation), no time loop and no other kernel")
    check(len(epochs["val_loss"]) == TRAIN_EPOCHS
          and np.isfinite(hist.history["on_batch_end"]["loss"]).all()
          and np.isfinite(epochs["val_loss"]).all()
          and saved.keys() == best.keys()
          and float(meta["val_loss"]) == min(epochs["val_loss"]),
          "train: the history or the checkpoint is wrong")

    # one batch's gradients against autograd through the plain recurrence
    xb, yb, mb = (torch.from_numpy(a[:TRAIN_BATCH]).cuda() for a in train)

    def fresh():
        return {k: v.detach().clone().requires_grad_(trains[k])
                for k, v in params.items()}

    def gradients(cfg, prm, scan, dtype=torch.float32):
        """The loss's gradients (as float64) of the scan's operands h0,
        dkT, dka, b (what the Function returns) and of the trainable
        parameters, with the scan's operands."""
        p = {k: v.detach().to(dtype).requires_grad_(trains[k])
             for k, v in prm.items()}
        x = xb.to(dtype)
        ops = drnmf.factored_scan_operands(
            p, cfg, x, drnmf.step_mask_from_input(x, cfg.mask_value))
        clean, noise = drnmf._heads(p, cfg, scan(*ops))
        irm = drnmf._ratio_mask(clean, noise, cfg.transform_before_irm)
        loss = masked_mse_signal_approx(irm, x, yb.to(dtype), mb.to(dtype))
        wrt = [ops[2], ops[6], ops[7], ops[8]] + [p[k] for k in names]
        got = torch.autograd.grad(loss, wrt)
        return ops, dict(zip(["h0", "dkT", "dka", "b"] + names,
                             (g.double() for g in got)))

    def rel_errs(got, want, ops):
        """Each gradient's max error relative to the largest entry of
        ``want``; log_alph_k's, a sum of two parts that cancel (through
        dka_k and b_k), relative to the parts' size."""
        errs = {}
        for key, b in want.items():
            err = (got[key] - b).abs().max().item()
            scale = b.abs().max().item()
            if key.startswith("log_alph"):
                k = int(key.rsplit("_", 1)[1])
                scale = (abs((ops[7][k].double() * want["dka"][k]).sum()
                             .item())
                         + abs((ops[8][k].double() * want["b"][k]).sum()
                               .item()))
            errs[key] = (err / scale if scale > 0
                         else (0.0 if err == 0 else np.inf))
        return errs

    # the flagship against autograd through the plain recurrence in f32;
    # at alph = 2000 (every layer active) both f32 routes against float64
    grad_rel, grad_launches = {}, {}
    for label, (cfg, prm) in (("flagship", (config, params)),
                              ("flagship_alph2000",
                               live_flagship(config, params))):
        reset_launches()
        _, got = gradients(cfg, prm, batched_grad.scan_factored_train)
        torch.cuda.synchronize()
        grad_launches[label] = read_launches()
        ops, want = gradients(cfg, prm,
                              drnmf_scan.drnmf_scan_factored_reference)
        _, h_all = drnmf_scan.drnmf_scan_factored(
            *(o.detach() for o in ops), keep_layers=True)
        grad_rel[label] = {
            "kernel_vs_plain": rel_errs(got, want, ops),
            # the share of each layer's units above zero over the batch
            "active_share_by_layer": (h_all > 0).float().mean(
                dim=(1, 2, 3)).tolist()}
        del h_all
        if label != "flagship":
            ops, f64 = gradients(cfg, prm,
                                 drnmf_scan.drnmf_scan_factored_reference,
                                 torch.float64)
            grad_rel[label].update(kernel_vs_f64=rel_errs(got, f64, ops),
                                   plain_vs_f64=rel_errs(want, f64, ops))
            del f64
        del got, want, ops
    # three Adam steps against the same steps on the plain Function
    def three_steps(scan_fn):
        p = fresh()
        step = make_train_step(loss_fn(scan_fn), make_optimizer(tc, p, trains))
        losses = [float(step(p, xb, yb, mb)) for _ in range(3)]
        return losses, p

    fast_losses, fast = three_steps(None)
    plain_losses, plain = three_steps(batched_grad.scan_factored_train_reference)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fast_losses,
                                                       plain_losses))
    param_off = {k: int((~torch.isclose(fast[k], plain[k], rtol=1e-4,
                                        atol=1e-6)).sum().item())
                 for k in names}
    param_diff = {k: (fast[k] - plain[k]).abs().max().item() for k in names}
    log("train_check", grad_rel_err=grad_rel,
        grad_rtol_of_max=GRAD_RTOL_OF_MAX,
        grad_rtol_against_f64=GRAD_RTOL_VS_F64, grad_launches=grad_launches,
        three_step_losses=fast_losses, three_step_losses_plain=plain_losses,
        loss_max_rel_diff=loss_rel, param_max_abs_diff=param_diff,
        params_past_tolerance=param_off, param_rtol=1e-4, param_atol=1e-6)
    check(all(n["factored"] == 1 and n["factored_backward"] == 1
              and only_launched(n, "factored", "factored_backward")
              for n in grad_launches.values()),
          f"a gradient launched {grad_launches}")
    check(all(v <= GRAD_RTOL_OF_MAX
              for v in grad_rel["flagship"]["kernel_vs_plain"].values())
          and all(v <= GRAD_RTOL_VS_F64 for v in
                  grad_rel["flagship_alph2000"]["kernel_vs_f64"].values()),
          f"gradients through the kernels disagree with the plain "
          f"recurrence's: {grad_rel}")
    check(loss_rel <= 1e-4 and not any(param_off.values()),
          "three steps on the kernels disagree with the plain Function's")
    del fast, plain

    # times: a step, then its parts, each beside its bound
    p = fresh()
    step = make_train_step(loss_fn(), make_optimizer(tc, p, trains))
    walls = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(p, xb, yb, mb)
        torch.cuda.synchronize()
        if i >= 2:
            walls.append(1e3 * (time.perf_counter() - t0))
    step_ms = statistics.median(walls)
    prof, device = profiled(lambda: step(p, xb, yb, mb), top=8)
    check(prof["busy_s"] is not None,
          "train step: the profiler traced no device op")
    kernel_ms = {part: 1e3 * trace.device_seconds(device, lambda n: sym in n)
                 / prof["calls"]
                 for part, sym in (("forward", "drnmf_scan_factored_kernel"),
                                   ("backward",
                                    "drnmf_scan_factored_bwd_kernel"))}
    args = drnmf.factored_scan_operands(params, config, xb,
                                        drnmf.step_mask_from_input(
                                            xb, config.mask_value))
    g = torch.randn((TRAIN_BATCH, TRAIN_T, config.hidden_dim),
                    generator=gen, device="cuda")
    fwd_ms = cuda_ms(lambda: drnmf_scan.drnmf_scan_factored(
        *args, keep_layers=True), 3)
    _, h_all = drnmf_scan.drnmf_scan_factored(*args, keep_layers=True)
    back_args = (g, args[1], h_all, *args[3:8])
    bwd_ms = cuda_ms(lambda: drnmf_scan.drnmf_scan_factored_backward(
        *back_args), 3)
    delta, p_all, gamma = drnmf_scan.drnmf_scan_factored_backward(*back_args)
    # the backward's plan and its time at one row
    plan = drnmf_scan.drnmf_scan_factored_backward_plan(
        h_all.shape[3], args[0].shape[2], config.hidden_dim,
        config.K_layers)
    one = [a[:1].contiguous() if i < 3 else a for i, a in enumerate(args)]
    _, h_one = drnmf_scan.drnmf_scan_factored(*one, keep_layers=True)
    one_args = (g[:1].contiguous(), one[1], h_one, *one[3:8])
    one_ms = cuda_ms(lambda: drnmf_scan.drnmf_scan_factored_backward(
        *one_args), 3)
    one_bound = train_parts(one, n_trainable)["backward"]
    del h_one, one_args
    no_dx = types.SimpleNamespace(needs_input_grad=(False, False))
    gemm_ms = cuda_ms(lambda: batched_grad._weight_grads(
        no_dx, args[0], h_all, delta, p_all, args[6], args[7]), 3)
    plain_bwd_ms = cuda_ms(
        lambda: drnmf_scan.drnmf_scan_factored_backward_reference(
            *back_args), 1)
    ref = drnmf_scan.drnmf_scan_factored_backward_reference(*back_args)
    errs = {name: compare(a, b)
            for name, a, b in zip(("delta", "p", "gamma"),
                                  (delta, p_all, gamma), ref)}
    bwd_err = max(e[0] for e in errs.values())
    check(all(e[2] for e in errs.values()),
          f"the backward kernel disagrees with its plain version at the "
          f"train step's shape: {errs}")
    del ref, delta, p_all, h_all
    bounds = train_parts(args, n_trainable)
    valid_frames = int(args[1].sum().item())
    busy_ms = 1e3 * prof["busy_s"]
    rest_ms = busy_ms - sum(kernel_ms.values()) - gemm_ms
    parts = {
        "forward": {"ms": fwd_ms, "ms_profiled": kernel_ms["forward"]},
        "backward": {"ms": bwd_ms, "ms_profiled": kernel_ms["backward"],
                     "plain_ms": plain_bwd_ms,
                     "instance": ("resident" if plan.resident
                                  else "streamed"),
                     "plan": plan._asdict(),
                     "syncs_per_step": plan.syncs_per_step,
                     "syncs_per_call": plan.syncs_per_step * TRAIN_T,
                     "us_per_step": 1e3 * bwd_ms / TRAIN_T,
                     "one_row": {"ms": one_ms,
                                 "us_per_step": 1e3 * one_ms / TRAIN_T,
                                 **{k: one_bound[k] for k in BOUND_KEYS},
                                 **shares(one_bound, one_ms)}},
        "weight_grads": {"ms": gemm_ms},
        "heads_loss_adam": {"ms_profiled_rest": rest_ms}}
    for key, b in bounds.items():
        parts[key].update({k: b[k] for k in ("flops", "bytes",
                                               *BOUND_KEYS)})
        if "ms" in parts[key]:
            parts[key].update(shares(b, parts[key]["ms"]))
    log("train_times", card=card, shape=[TRAIN_BATCH, TRAIN_T],
        step_ms=step_ms, step_ms_runs=walls, steps_per_s=1e3 / step_ms,
        frames_per_s=valid_frames * 1e3 / step_ms,
        valid_frames_a_step=valid_frames,
        backward_max_abs_err={k: e[0] for k, e in errs.items()},
        backward_max_rel_err={k: e[1] for k, e in errs.items()},
        parts=parts, profile=prof)
    check(all(v["ms"] >= bounds[k]["bound_ms"]
              for k, v in parts.items() if "ms" in v)
          and one_ms >= one_bound["bound_ms"],
          f"a part of the train step reads faster than its bound: {parts}")
    return launches, {
        "name": "drnmf_scan_factored_backward",
        "route": "cuda",
        "source": "drnmf_torch/ops/csrc/drnmf_scan_factored_bwd.cu",
        "replaces": "drnmf_tpu/models/batched_grad.py:99",
        "launches": launches["factored_backward"],
        "max_abs_err": bwd_err,
        "ms": bwd_ms,
        "plain_ms": plain_bwd_ms,
        **{k: bounds["backward"][k] for k in BOUND_KEYS},
        # no single PyTorch call computes the reverse chain
        "library_ms": None,
    }


def predict_launches(tensors_file, bucket_frames=128, batch=250):
    """B1 launches that ``pipeline.predict_irm`` makes on a split: one a
    batch of each length bucket (the pipeline's own cut)."""
    x = np.load(tensors_file)["x"]
    valid = np.any(x != -1.0, axis=-1)
    lengths = np.where(valid.any(axis=1),
                       x.shape[1] - valid[:, ::-1].argmax(axis=1), 0)
    buckets = {}
    for ln in lengths:
        t_b = min(x.shape[1], -(-max(int(ln), 1) // bucket_frames)
                  * bucket_frames)
        buckets[t_b] = buckets.get(t_b, 0) + 1
    return sum(-(-n // batch) for n in buckets.values())


def pipeline_phase(card):
    """Phase ``pipeline`` (module docstring).  Returns the flagship fit's
    launches."""
    import shutil

    import torch
    import yaml
    from drnmf_torch import cli
    from drnmf_torch.config import config_hash, drnmf_config_from_params
    from drnmf_torch.data import make_synthetic_corpus, wsj0_like_lengths
    from drnmf_torch.dsp.wav import wavread
    from drnmf_torch.models import ensure_fold_valid
    from drnmf_torch.train import TrainingDeadline, load_checkpoint

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke", "pipeline")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    taskfiles = make_synthetic_corpus(
        os.path.join(root, "audio"), n_files=PIPE_FILES, seed=PIPE_SEED,
        lengths=wsj0_like_lengths(np.random.default_rng(PIPE_SEED),
                                  PIPE_FILES))
    corpus_s = time.perf_counter() - t0
    data = dict(PIPE_DATA)
    for split in ("train", "valid", "test"):
        data[f"taskfile_x_{split}"] = taskfiles["noisy"]
        data[f"taskfile_y_{split}"] = taskfiles["clean"]
    paths = {}
    for name, cfg in (("data", data), ("unfolded_snmf", PIPE_DRNMF),
                      ("snmf", PIPE_SNMF), ("lstm", PIPE_LSTM),
                      ("unfolded_snmf_resume", {**PIPE_DRNMF,
                                                "resume": True})):
        paths[name] = os.path.join(root, f"params_{name}.yaml")
        with open(paths[name], "w") as fh:
            yaml.safe_dump(cfg, fh)
    exp = os.path.join(root, "exp")

    def run(config, exp_dir=exp, splits="test", score=False, extra=()):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cli.main(["-c", paths[config], "-d", paths["data"],
                        "--exp-dir", exp_dir, "--splits", splits, "-q",
                        *extra, *(() if score else ("--no-score",))])
        torch.cuda.synchronize()
        return out, read_launches(), time.perf_counter() - t0

    def stages(timer):
        return {name: secs for name, secs, _ in timer.stages}

    # the flagship scores its test split (the default); the engine's calls
    # are counted to show that the cached rerun reads the score files
    from drnmf_torch.metrics import engine
    engine_calls = []
    score_all_packed = engine.score_all_packed

    def counted(ests, *args, **kwargs):
        engine_calls.append(len(ests))
        return score_all_packed(ests, *args, **kwargs)

    engine.score_all_packed = counted
    try:
        (best, config, res), fit_launches, fit_s = run("unfolded_snmf",
                                                       score=True)
        fit_engine_rows = sum(engine_calls)
        h = config_hash(PIPE_DRNMF)
        score_dir = os.path.join(exp, "scores")
        score_files = sorted(os.listdir(score_dir))
        mtimes = {f: os.stat(os.path.join(score_dir, f)).st_mtime_ns
                  for f in score_files}
        del engine_calls[:]
        (_, _, res2), cached_launches, cached_s = run("unfolded_snmf",
                                                      score=True)
        cached_untouched = len(engine_calls) == 0 and all(
            os.stat(os.path.join(score_dir, f)).st_mtime_ns == t
            for f, t in mtimes.items())
        (_, _, res3), rescore_launches, rescore_s = run(
            "unfolded_snmf", score=True, extra=("--rescore",))
        rescore_engine_rows = sum(engine_calls)
    finally:
        engine.score_all_packed = score_all_packed
    timer, timer2 = res["timer"], res2["timer"]
    from drnmf_torch.metrics.scoring import SCORE_LABELS, SNRS
    check(score_files == [f"scores_unfolded_snmf_{h}_test_{snr}.npz"
                          for snr in sorted(SNRS)],
          f"pipeline: the score files are {score_files}")
    overall = res["test"][0].ravel()
    check(np.isfinite(overall).all() and overall[4] != -1.0,
          f"pipeline: the overall scores {overall} are not finite")
    check(fit_engine_rows == PIPE_FILES,
          f"pipeline: the engine scored {fit_engine_rows} rows, expected "
          f"{PIPE_FILES}")
    check(cached_untouched
          and np.array_equal(res2["test"][0], res["test"][0]),
          "pipeline: the cached rerun scored again or read other scores")
    rescore_diff = np.abs(res3["test"][0] - res["test"][0]).ravel()
    check(rescore_engine_rows == PIPE_FILES
          and bool(np.all(rescore_diff <= np.array(SCORE_TOLS))),
          f"pipeline: --rescore scored {rescore_engine_rows} rows, "
          f"overall {res3['test'][0]} against {res['test'][0]}")
    with open(os.path.join(exp, "history", f"history_unfolded_snmf_{h}"),
              "rb") as fh:
        steps = len(pickle.load(fh)["on_batch_end"]["loss"])
    n_predict = predict_launches(os.path.join(exp, "tensors_test_full.npz"))
    check(fit_launches["pass1"] > 0 and fit_launches["pass2"] > 0
          and fit_launches["factored_backward"] == steps
          and fit_launches["factored"] == steps + PIPE_EPOCHS + n_predict
          and only_launched(fit_launches, "pass1", "pass2", "factored",
                            "factored_backward"),
          f"pipeline: the fit's launches {fit_launches}, expected B4/B5, "
          f"{steps} of the backward kernel and {steps} + {PIPE_EPOCHS} + "
          f"{n_predict} of B1 (steps, evaluations, predict_irm)")
    check(cached_launches["factored"] == n_predict
          and only_launched(cached_launches, "factored")
          and rescore_launches == cached_launches,
          f"pipeline: the cached runs launched {cached_launches} and "
          f"{rescore_launches}, expected only predict_irm's {n_predict} of "
          f"B1")

    # every enhanced wav: there, finite, the noisy length rounded up to
    # the hop (the reference's iSTFT length)
    with open(taskfiles["noisy"]) as fh:
        noisy = fh.read().split()
    with open(taskfiles["clean"]) as fh:
        clean = fh.read().split()
    desc = f"unfolded_snmf_{h}_test"
    enhanced = [c.replace("scaled", f"enhanced_{desc}") for c in clean]
    lengths_ok = True
    for x_path, e_path in zip(noisy, enhanced):
        check(os.path.isfile(e_path), f"pipeline: no enhanced wav {e_path}")
        e = wavread(e_path)[0]
        n = wavread(x_path).shape[1]
        check(np.isfinite(e).all(), f"pipeline: {e_path} is not finite")
        lengths_ok &= len(e) == -(-n // HOP) * HOP
    check(lengths_ok, "pipeline: an enhanced wav has another length than "
          "its noisy file's rounded up to the hop")
    # 4 test files against enhance_signals with the same best checkpoint
    from drnmf_torch.enhance import enhance_signals
    params, _ = load_checkpoint(os.path.join(
        exp, "models", f"model_unfolded_snmf_{h}.npz"))
    cfg = ensure_fold_valid(drnmf_config_from_params(PIPE_DRNMF, 257),
                            params, verbose=False)
    signals = [wavread(noisy[j])[0] for j in range(4)]
    direct = enhance_signals(params, cfg, signals, N_FFT, HOP)
    wave_err = 0.0
    for j, want in enumerate(direct):
        got = wavread(enhanced[j])[0][:len(want)]
        err = np.abs(got - want)
        check(bool((err <= PIPE_WAV_ATOL + PIPE_WAV_RTOL * np.abs(want))
                   .all()), f"pipeline: test file {j} differs from "
              f"enhance_signals by {err.max()}")
        wave_err = max(wave_err, float(err.max()))

    (_, _, snmf_res), snmf_launches, snmf_s = run("snmf")
    check(snmf_launches["pass1"] > 0 and snmf_launches["pass2"] > 0
          and only_launched(snmf_launches, "pass1", "pass2"),
          f"pipeline: snmf launched {snmf_launches}, expected B4/B5 only")
    (_, _, lstm_res), lstm_launches, lstm_s = run("lstm")
    check(only_launched(lstm_launches),
          f"pipeline: the LSTM launched {lstm_launches}, expected nothing")
    h_lstm = config_hash(PIPE_LSTM)
    with open(os.path.join(exp, "history", f"history_lstm_{h_lstm}"),
              "rb") as fh:
        lstm_steps = len(pickle.load(fh)["on_batch_end"]["loss"])

    # resume: the flagship fit stopped after epoch 1 by the deadline, then
    # resumed, against the uninterrupted fit above (its dictionary copied in)
    exp_resume = os.path.join(root, "exp_resume")
    shutil.copytree(os.path.join(exp, "dicts"),
                    os.path.join(exp_resume, "dicts"))
    os.environ["DRNMF_TRAIN_DEADLINE_TS"] = "1.0"
    try:
        run("unfolded_snmf_resume", exp_resume, "")
        check(False, "pipeline: the deadline did not stop the fit")
    except TrainingDeadline:
        pass
    finally:
        del os.environ["DRNMF_TRAIN_DEADLINE_TS"]
    (resumed, _, _), resume_launches, resume_s = run(
        "unfolded_snmf_resume", exp_resume, "")
    resume_err = max(float(np.abs(resumed[k] - best[k]).max()
                           / max(float(np.abs(best[k]).max()), 1e-30))
                     for k in best)
    check(resume_err <= PIPE_RESUME_RTOL_OF_MAX,
          f"pipeline: the resumed fit is {resume_err} (of each parameter's "
          f"largest entry) from the uninterrupted one")

    audio_s = timer.audio_seconds()
    log("pipeline", card=card, files=PIPE_FILES, audio_seconds=audio_s,
        corpus_seconds=corpus_s, fit_run_seconds=fit_s,
        fit_stages=stages(timer), cached_run_seconds=cached_s,
        cached_stages=stages(timer2),
        overall_scores=dict(zip(SCORE_LABELS, overall.tolist())),
        score_files=len(score_files),
        score_rtf=audio_s / timer.seconds("score:test"),
        rescore_run_seconds=rescore_s,
        rescore_score_seconds=res3["timer"].seconds("score:test"),
        rescore_max_abs_diff=rescore_diff.tolist(),
        rescore_bit_equal=bool(np.array_equal(res3["test"][0],
                                              res["test"][0])),
        dictionary_seconds=timer.seconds("dictionary"),
        train_steps=steps,
        train_ms_a_step=1e3 * timer.seconds("train") / steps,
        rtf_predict_reconstruct=timer.realtime_factor(),
        cached_rtf_predict_reconstruct=timer2.realtime_factor(),
        launches={"fit": fit_launches, "cached": cached_launches,
                  "snmf": snmf_launches, "lstm": lstm_launches,
                  "resume": resume_launches},
        predict_launches=n_predict, lengths_hop_rounded=lengths_ok,
        enhance_signals_max_abs_diff=wave_err,
        snmf_run_seconds=snmf_s, snmf_stages=stages(snmf_res["timer"]),
        snmf_rtf=snmf_res["timer"].realtime_factor(),
        lstm_run_seconds=lstm_s, lstm_stages=stages(lstm_res["timer"]),
        lstm_steps=lstm_steps,
        lstm_ms_a_step=1e3 * lstm_res["timer"].seconds("train") / lstm_steps,
        lstm_rtf=lstm_res["timer"].realtime_factor(),
        resume_run_seconds=resume_s, resume_max_rel_err=resume_err,
        phase_seconds=time.perf_counter() - t_phase)
    return fit_launches, enhanced, noisy, clean


def reference_conditioning(refs, flen=512):
    """The smallest eigenvalue over r[0] of each reference's flen x flen
    Toeplitz autocorrelation matrix, in float64 on the host."""
    import scipy.linalg

    out = []
    for ref in refs:
        x = np.asarray(ref, np.float64)
        nfft = 1 << (len(x) + flen - 1).bit_length()
        sf = np.fft.rfft(x, nfft)
        r = np.fft.irfft(sf * np.conj(sf), nfft)[:flen]
        out.append(scipy.linalg.eigvalsh(scipy.linalg.toeplitz(r))[0]
                   / max(r[0], 1e-300))
    return np.array(out)


def hold_scores(got, want, ridges_got, ridges_want, conditioning=None):
    """Rows of two (n, 6) score tables against each other at SCORE_TOLS:
    SDR only where ``conditioning`` (``reference_conditioning``) is given,
    at ILL_CONDITIONED_SDR_TOL on its ill-conditioned rows, and by ridge
    where the two kept different ridges.  A NaN on one side only fails.
    Returns the largest difference by column, the rows whose kept ridge
    differs and the largest SDR difference on the ill-conditioned rows."""
    worst = [0.0] * 6
    other_ridge = []
    worst_ill = 0.0
    for i in range(len(got)):
        for col, tol in enumerate(SCORE_TOLS):
            a, b = float(got[i, col]), float(want[i, col])
            check(np.isnan(a) == np.isnan(b),
                  f"score: row {i} column {col} is {a} against {b}")
            if a == b or np.isnan(a) or (col == 0 and conditioning is None):
                continue
            diff = abs(a - b)
            if col == 0:
                ill = conditioning[i] < ILL_CONDITIONED
                tol = ILL_CONDITIONED_SDR_TOL if ill else tol
                ra, rb = ridges_got[i], ridges_want[i]
                first = [int(np.argmax(np.isfinite(r))) for r in (ra, rb)]
                if first[0] != first[1]:
                    both = np.isfinite(ra) & np.isfinite(rb)
                    check(bool(np.all(np.abs(ra - rb)[both] <= tol)),
                          f"score: row {i} SDR by ridge {ra} against {rb}")
                    other_ridge.append(i)
                    continue
                if ill:
                    check(diff <= tol, f"score: row {i} SDR {a} against "
                          f"{b} (ill-conditioned, tolerance {tol})")
                    worst_ill = max(worst_ill, diff)
                    continue
            check(diff <= tol, f"score: row {i} column {col} is {a} "
                  f"against {b} (tolerance {tol})")
            worst[col] = max(worst[col], diff)
    return worst, other_ridge, worst_ill


def bench_score_battery():
    """bench.py::bench_score's pairs, by its recipe (without importing
    it): a sinusoid of 120-280 Hz at 2 Hz AM and white noise, PCM16."""
    rng = np.random.default_rng(BENCH_SCORE_SEED)
    ests, refs = [], []
    for i in range(BENCH_SCORE_FILES):
        n = int(FS * rng.uniform(2.0, 5.0))
        t = np.arange(n) / FS
        f0 = 120 + 40 * (i % 5)
        ref = (0.1 * np.sin(2 * np.pi * f0 * t)
               * (0.5 + 0.5 * np.sin(2 * np.pi * 2.0 * t))).astype(np.float32)
        est = ref + 0.02 * rng.standard_normal(n).astype(np.float32)
        for x, out in ((est, ests), (ref, refs)):
            out.append(np.clip(np.round(x * 32768.0), -32768,
                               32767).astype(np.int16))
    return ests, refs


def score_ops(ests, refs):
    """Device ms of the parts of one engine pass on its largest bucket:
    the forward FFT of the rows, the SDR (its FFTs, the batched Cholesky
    factorization and solve), the factorization alone, the delay, PESQ
    and its smoothing loop alone, STOI and its segment gather alone, and
    the bucket's whole pass."""
    import torch
    from drnmf_torch.metrics import bss_eval, engine, pesq_device, stoi_device
    from drnmf_torch.metrics.stoi import (FRAME, _WINDOW, _band_envelopes,
                                          _segment_scores, hop_frames)
    from drnmf_torch.metrics.fused import pack_pair, to_device

    device = torch.device("cuda")
    lens = np.array([min(len(e), len(r)) for e, r in zip(ests, refs)])
    buckets = {}
    for i, n in enumerate(lens):
        buckets.setdefault(bss_eval._next_pow2(n + bss_eval.FLEN),
                           []).append(i)
    nfft, idxs = max(buckets.items(), key=lambda kv: (len(kv[1]), kv[0]))
    est_c, ref_c, offsets = pack_pair(ests, refs, idxs, lens, np.int16)
    off = to_device(offsets, device)
    w = [nfft, None, (to_device(est_c, device), to_device(ref_c, device),
                      off, off, to_device(lens[idxs], device))]
    se, s, n_t = engine._rows(w)
    flen = bss_eval.FLEN
    r = torch.fft.irfft(torch.fft.rfft(s) * torch.fft.rfft(s).conj(),
                        n=nfft)[:, :flen]
    ar = torch.arange(flen, device=device)
    R = r[:, (ar[:, None] - ar[None, :]).abs()] + 1e-7 * r[:, :1, None] \
        * torch.eye(flen, device=device)
    raw = torch.rand(len(idxs), nfft // 256 - 1, device=device) + 0.5
    xs = stoi_device.resample_rows_16k_to_10k(s, n_t)[0]
    xb = _band_envelopes(hop_frames(xs, FRAME)
                         * torch.as_tensor(_WINDOW, device=device))
    m = torch.full((len(idxs),), xb.shape[-1], device=device)
    ms = {
        "rfft_rows": cuda_ms(lambda: torch.fft.rfft(s), 5),
        "sdr": cuda_ms(lambda: bss_eval._sdr_padded(se, s, n_t), 3),
        "cholesky": cuda_ms(lambda: torch.linalg.cholesky_ex(R), 3),
        "delay": cuda_ms(lambda: engine._delay_rows(se, s, n_t), 3),
        "pesq": cuda_ms(lambda: pesq_device.pesq_rows(s, se, n_t), 3),
        "pesq_smooth_gain": cuda_ms(lambda: pesq_device.smooth_gain(raw), 3),
        "stoi": cuda_ms(lambda: stoi_device.stoi_rows(s, se, n_t), 3),
        "stoi_segment_gather": cuda_ms(
            lambda: _segment_scores(xb, xb, m), 3),
        "bucket_pass": cuda_ms(lambda: engine._engine_bucket(
            w, bss_eval.RIDGES[0], flen, 160, FS, True), 3),
    }
    return {"nfft": nfft, "rows": len(idxs), "ms": ms}


def score_kernel_groups(device):
    """Device ms of ``profiled``'s operations (all its calls) summed by
    what the kernels do (by name): FFTs, the Cholesky factorization and
    solve, gathers, the rest."""
    groups = {"fft": 0.0, "cholesky_solve": 0.0, "gather": 0.0, "other": 0.0}
    for start, end, name in device:
        low = name.lower()
        key = ("fft" if "fft" in low else "cholesky_solve"
               if any(k in low for k in ("potr", "chol", "trsm", "trsv"))
               else "gather" if any(k in low for k in ("gather", "index"))
               else "other")
        groups[key] += 1e-3 * (end - start)
    return groups


def score_phase(card, enhanced, noisy, clean):
    """Phase ``score`` (module docstring)."""
    import torch
    from drnmf_torch.data.native_loader import read_batch_i16
    from drnmf_torch.metrics import _pesq_model, engine
    from drnmf_torch.metrics.stoi import stoi
    from drnmf_torch.metrics.bss_eval import FLEN, _next_pow2

    t_phase = time.perf_counter()
    def pcm16(paths):
        data, lens = read_batch_i16(paths)
        return [data[i, :lens[i]] for i in range(len(paths))]

    clean_pcm = pcm16(clean)
    for part, (ests, refs) in (
            ("pipeline_corpus", (pcm16(enhanced), clean_pcm)),
            ("pipeline_noisy", (pcm16(noisy), clean_pcm)),
            ("bench_score", bench_score_battery())):
        corpus = part.startswith("pipeline")
        lens = [min(len(e), len(r)) for e, r in zip(ests, refs)]
        audio_s = sum(lens) / FS
        buckets = {}
        for n in lens:
            nfft = _next_pow2(n + FLEN)
            buckets[nfft] = buckets.get(nfft, 0) + 1

        def call():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine.score_all_packed(ests, refs, device="cuda")
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        torch.backends.cuda.cufft_plan_cache.clear()
        (got, delays), first_s = call()
        warm = [call() for _ in range(SCORE_TIMED_CALLS)]
        warm_s = statistics.median(s for _, s in warm)
        repeat_equal = all(np.array_equal(S, got, equal_nan=True)
                           and np.array_equal(d, delays)
                           for (S, d), _ in warm)
        t0 = time.perf_counter()
        want, want_delays = engine.score_all_packed(ests, refs, device="cpu")
        cpu_s = time.perf_counter() - t0
        check(np.array_equal(delays, want_delays),
              f"score ({part}): delays differ from the CPU's")
        ridges = engine.sdr_at_ridges(ests, refs, device="cuda")
        ridges_cpu = engine.sdr_at_ridges(ests, refs, device="cpu")
        # the near-periodic battery's SDR is held only to be finite
        # (SCORE_TOLS' comment)
        conditioning = (reference_conditioning(
            [r[:n] for r, n in zip(refs, lens)]) if corpus else None)
        worst, other_ridge, worst_ill = hold_scores(
            got, want, ridges, ridges_cpu, conditioning)
        other_ridge_sdr = (float(np.max(np.abs(got[other_ridge, 0]
                                               - want[other_ridge, 0])))
                           if other_ridge else 0.0)
        check(bool(np.isfinite(got[:, 0]).all()),
              f"score ({part}): a non-finite SDR")
        def escalated(by_ridge):
            out = {f"{a:g}->{b:g}": int(np.sum(
                np.isnan(by_ridge[:, k]) & np.isfinite(by_ridge[:, k + 1])))
                for k, (a, b) in enumerate(zip(engine.RIDGES,
                                               engine.RIDGES[1:]))}
            out["fallback"] = int(np.sum(~np.isfinite(by_ridge).any(1)))
            return out
        host = {}
        if corpus:
            # PESQ against the float64 host model, STOI against the
            # per-file path, on 8 files
            pesq_err = stoi_err = 0.0
            for i in range(min(8, len(ests))):
                r64, e64 = refs[i] / 32768.0, ests[i] / 32768.0
                pesq_err = max(pesq_err, abs(
                    got[i, 4] - _pesq_model.pesq_mos_aligned(r64, e64)))
                stoi_err = max(stoi_err, abs(
                    got[i, 5] - stoi(r64, e64, device="cuda")))
            check(pesq_err <= SCORE_TOLS[4] and stoi_err <= SCORE_TOLS[5],
                  f"score ({part}): PESQ {pesq_err} from the host model, "
                  f"STOI {stoi_err} from the per-file path")
            host = {"pesq_max_abs_diff_to_host_f64": pesq_err,
                    "stoi_max_abs_diff_to_per_file": stoi_err}
        split, device = profiled(
            lambda: engine.score_all_packed(ests, refs, device="cuda"), top=12)
        groups = {k: ms / split["calls"]
                  for k, ms in score_kernel_groups(device).items()}
        log("score", part=part, card=card, files=len(ests),
            audio_seconds=audio_s,
            buckets=[{"nfft": k, "rows": v} for k, v in sorted(
                buckets.items())],
            first_call_seconds=first_s, warm_seconds=[s for _, s in warm],
            score_rtf_first=audio_s / first_s,
            score_rtf_warm_median=audio_s / warm_s,
            cpu_engine_seconds=cpu_s, repeat_bit_equal=repeat_equal,
            max_abs_diff_to_cpu=dict(zip(("SDR", "SNR", "SegSNR local",
                                          "SegSNR global", "PESQ", "STOI"),
                                         worst)),
            rows_kept_at_another_ridge_than_cpu=other_ridge,
            other_ridge_sdr_max_abs_diff_to_cpu=other_ridge_sdr,
            ill_conditioned_rows=(None if conditioning is None else int(
                np.sum(conditioning < ILL_CONDITIONED))),
            ill_conditioned_sdr_max_abs_diff_to_cpu=worst_ill,
            min_eigenvalue_over_r0=(None if conditioning is None else [
                float(conditioning.min()), float(np.median(conditioning))]),
            escalated_rows=escalated(ridges),
            escalated_rows_cpu=escalated(ridges_cpu),
            delays_nonzero=int(np.sum(delays != 0)),
            means=got.mean(axis=0).tolist(), **host,
            device_ms_by_group=groups,
            device_ms_by_op=score_ops(ests, refs), profile=split)
    log("score_done", phase_seconds=time.perf_counter() - t_phase)


def parallel_fit(mesh, layout, config, params, train, valid):
    """The flagship through ``train_model`` for one epoch of PAR_STEPS
    steps: alone (``mesh`` None), data parallel (``layout`` "dp"), FSDP
    ("fsdp") or tensor parallel ("tp", ``parallel.drnmf_apply_tp_dp``).
    Returns the trainable best parameters, the history, the bytes held
    (``history.layout``), the wall time between the loss calls of
    successive steps (synchronised) and one step's collectives."""
    import torch
    from drnmf_torch.models import drnmf
    from drnmf_torch.parallel import drnmf_apply_tp_dp
    from drnmf_torch.train import (TrainConfig, masked_mse_signal_approx,
                                   train_model)

    marks = []

    def loss(p, x, y, mask):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(),
                      None if mesh is None else dict(mesh.traffic),
                      None if mesh is None else dict(mesh.calls)))
        if layout == "tp":
            irm = drnmf_apply_tp_dp(p, config, x, drnmf.step_mask_from_input(
                x, config.mask_value), mesh)
        else:
            irm = drnmf.drnmf_forward(p, config, x)
        return masked_mse_signal_approx(irm, x, y, mask)

    # each collective's wall time, the device synchronised before and
    # after it: the collective itself, gloo's copies through host memory
    # included, apart from the kernels queued before it
    spans = []

    def timed(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans.append((t0, time.perf_counter()))
            return out
        return call

    collectives = ("reduce", "gather", "reduce_scatter")
    for name in collectives if mesh is not None else ():
        setattr(mesh, name, timed(getattr(mesh, name)))
    tc = TrainConfig(epochs=1, batch_size=TRAIN_BATCH,
                     learning_rate=TRAIN_LR, clipnorm=0.0, patience=50,
                     verbose=False)
    trains = drnmf.drnmf_trainable_mask(config, params)
    t0 = time.perf_counter()
    try:
        best, hist = train_model(params, loss, train, valid, tc,
                                 trainable_mask=trains, mesh=mesh,
                                 fsdp=layout == "fsdp")
    finally:
        for name in collectives if mesh is not None else ():
            delattr(mesh, name)  # the class's methods again
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    # loss call i starts step i; the first evaluation's ends the last step
    step_s = [b[0] - a[0] for a, b in zip(marks[:PAR_STEPS],
                                          marks[1:PAR_STEPS + 1])]
    one_step = None if mesh is None else {
        axis: {"bytes": marks[2][1][axis] - marks[1][1][axis],
               "collectives": marks[2][2][axis] - marks[1][2][axis]}
        for axis in ("dp", "tp")}
    if one_step is not None:  # step 2's collectives, in ms
        one_step["ms"] = 1e3 * sum(b - a for a, b in spans
                                   if marks[1][0] <= a < marks[2][0])
    return {"best": {k: v for k, v in best.items() if trains[k]},
            "history": hist.history, "resident": hist.layout,
            "step_ms": [1e3 * s for s in step_s],
            "ms_a_step": 1e3 * statistics.median(step_s),
            "fit_seconds": fit_s, "one_step_collectives": one_step}


def parallel_rank(rank, work, config, wavs, snmf_kw):
    """One rank of the ``parallel`` phase's group: the fits in the dp, FSDP
    and tp layouts, sparse NMF and the scoring of the pipeline's test
    split, each path's launches counted on its own."""
    import torch
    from drnmf_torch.data.native_loader import read_batch_i16
    from drnmf_torch.metrics import engine
    from drnmf_torch.metrics.bss_eval import FLEN, _next_pow2
    from drnmf_torch.metrics.sharded import deal_rows, score_all_sharded
    from drnmf_torch.ops.snmf import SNMFParams, sparse_nmf
    from drnmf_torch.parallel import (make_mesh, make_mesh_2d,
                                      sparse_nmf_sharded)

    dp = make_mesh()
    tp = make_mesh_2d(1, PAR_RANKS)
    data = np.load(os.path.join(work, "fit_data.npz"))
    train = (data["x"], data["y"], data["mask"])
    valid = (data["vx"], data["vy"], data["vmask"])
    params = dict(np.load(os.path.join(work, "flagship.npz")))
    out = {"backend": dp.backend, "device": str(dp.device),
           "ranks_per_device": dp.ranks_per_device}
    for layout, mesh in (("dp", dp), ("fsdp", dp), ("tp", tp)):
        reset_launches()
        out[layout] = parallel_fit(mesh, layout, config, params, train,
                                   valid)
        out[layout]["launches"] = read_launches()

    # sparse NMF, frames split over the ranks, against one process; an
    # iteration's time is read between the divergence sums (B5's, one
    # collective of one entry, the last of each iteration), each of which
    # waits for the iteration's device work
    v = np.load(os.path.join(work, "snmf_v.npy"))
    marks = []
    reduce = dp.reduce

    def timed_reduce(*tensors, **kw):
        summed = reduce(*tensors, **kw)
        if len(tensors) == 1 and tensors[0].numel() == 1:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        return summed

    dp.reduce = timed_reduce
    reset_launches()
    before = (dict(dp.traffic), dict(dp.calls))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sparse_nmf_sharded(v, SNMFParams(**snmf_kw,
                                           max_iter=PAR_SNMF_ITERS), dp)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    dp.reduce = reduce
    launches = read_launches()
    traffic = dp.traffic["dp"] - before[0]["dp"]
    calls = dp.calls["dp"] - before[1]["dp"]
    ref = sparse_nmf(v, SNMFParams(**snmf_kw, max_iter=PAR_SNMF_ITERS),
                     device=dp.device)
    errs = {name: float(np.abs(got - want).max() / np.abs(want).max())
            for name, got, want in (("w", res.w, ref.w), ("h", res.h, ref.h),
                                    ("cost", res.cost, ref.cost))}
    iter_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    out["snmf"] = {"launches": launches, "max_rel_err_of_max": errs,
                   "n_iter": res.n_iter, "ref_n_iter": ref.n_iter,
                   "call_seconds": call_s, "iteration_ms": iter_ms,
                   "ms_an_iteration": statistics.median(iter_ms),
                   # the whole call's collectives: two an iteration (B4's
                   # statistics, B5's divergence) and H's gather
                   "collective_bytes": traffic, "collectives": calls}
    del res, ref, v

    # the pipeline's test split scored, its files split over the ranks
    def pcm16(paths):
        x, lens = read_batch_i16(paths)
        return [x[i, :lens[i]] for i in range(len(paths))]

    ests, refs = pcm16(wavs["enhanced"]), pcm16(wavs["clean"])

    def score():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = score_all_sharded(ests, refs, dp, fs=FS)
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    (S, delays), first_s = score()
    (S2, _), warm_s = score()
    # the SDR of this rank's rows at each ridge, in its batches
    lens = np.array([min(len(e), len(r)) for e, r in zip(ests, refs)])
    buckets = {}
    for i, n in enumerate(lens):
        buckets.setdefault(_next_pow2(n + FLEN), []).append(i)
    mine = [i for _, idxs in sorted(buckets.items())
            for i in deal_rows(idxs, lens, dp.n_dp)[dp.i_dp]]
    ridges = engine.sdr_at_ridges([ests[i] for i in mine],
                                  [refs[i] for i in mine], device=dp.device)
    out["score"] = {"S": S, "delays": delays, "rows": mine,
                    "ridges": ridges, "first_seconds": first_s,
                    "warm_seconds": warm_s,
                    "repeat_bit_equal": bool(np.array_equal(
                        S, S2, equal_nan=True)),
                    "audio_seconds": float(lens.sum()) / FS}
    return out


def parallel_cli(card, pipe_root, work):
    """Phase ``parallel``, part (d): the CLI's multi-rank layouts at the
    flagship on the pipeline phase's corpus.  Returns what it logs."""
    import contextlib
    import io
    import shutil

    import yaml
    from drnmf_torch import cli
    from drnmf_torch.config import config_hash
    from drnmf_torch.dsp.wav import wavread
    from drnmf_torch.metrics.scoring import (SCORE_LABELS, SNRS,
                                             aggregate_snr_scores)

    root = os.path.join(work, "cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    model = {**PIPE_DRNMF, "epochs": 1}
    h = config_hash(model)
    with open(os.path.join(pipe_root, "params_data.yaml")) as fh:
        data = yaml.safe_load(fh)
    # the --tp run's corpus: the first files, about PAR_TP_SEQS sequences
    with open(data["taskfile_x_train"]) as fh:
        noisy = fh.read().split()
    with open(data["taskfile_y_train"]) as fh:
        clean = fh.read().split()
    n_files, seqs = 0, 0
    while seqs < PAR_TP_SEQS:
        frames = wavread(noisy[n_files]).shape[1] // HOP + 1
        seqs += -(-frames // PIPE_DATA["maxlen"])
        n_files += 1
    small = dict(data)
    for split in ("train", "valid", "test"):
        for side, files in (("x", noisy), ("y", clean)):
            path = os.path.join(root, f"{side}_{split}.txt")
            with open(path, "w") as fh:
                fh.write("\n".join(files[:n_files]) + "\n")
            small[f"taskfile_{side}_{split}"] = path
    paths = {}
    for name, cfg in (("data", data), ("data_small", small),
                      ("unfolded_snmf", model), ("lstm", PIPE_LSTM)):
        paths[name] = os.path.join(root, f"params_{name}.yaml")
        with open(paths[name], "w") as fh:
            yaml.safe_dump(cfg, fh)

    def exp_dir(name, cached=True):
        # the pipeline phase's dictionary and featurized splits
        exp = os.path.join(root, f"exp_{name}")
        os.makedirs(exp)
        if cached:
            shutil.copytree(os.path.join(pipe_root, "exp", "dicts"),
                            os.path.join(exp, "dicts"))
            for f in os.listdir(os.path.join(pipe_root, "exp")):
                if f.startswith("tensors_"):
                    shutil.copy(os.path.join(pipe_root, "exp", f), exp)
        return exp

    def argv(name, data_key, splits, exp):
        return ["-c", paths[name], "-d", paths[data_key], "--exp-dir", exp,
                "--splits", splits]

    def overall(exp):
        per_snr = []
        for snr in SNRS:
            with np.load(os.path.join(exp, "scores", f"scores_unfolded_"
                                      f"snmf_{h}_test_{snr}.npz")) as f:
                per_snr.append((f["S"], None))
        return aggregate_snr_scores(per_snr, len(noisy)).ravel()

    def losses(exp):
        with open(os.path.join(exp, "history",
                               f"history_unfolded_snmf_{h}"), "rb") as fh:
            return pickle.load(fh)["on_batch_end"]["loss"]

    def command(tag, args):
        """The CLI as a user runs it, in a process of its own."""
        t0 = time.perf_counter()
        log_path = os.path.join(root, f"{tag}.log")
        with open(log_path, "w") as fh:
            proc = subprocess.run(
                [sys.executable, "-m", "drnmf_torch.cli", *args],
                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=fh,
                stderr=subprocess.STDOUT, timeout=2 * PAR_TIMEOUT_S)
        with open(log_path) as fh:
            text = fh.read()
        check(proc.returncode == 0,
              f"parallel: the CLI {tag} exited {proc.returncode}: "
              f"{text[-3000:]}")
        mesh_line = next((ln for ln in text.splitlines()
                          if ln.startswith("mesh:")), None)
        return mesh_line, time.perf_counter() - t0

    t0 = time.perf_counter()
    single = exp_dir("single")
    cli.main(argv("unfolded_snmf", "data", "test", single) + ["-q"])
    single_s = time.perf_counter() - t0
    want = overall(single)
    runs = {}
    for tag, extra in (("dp2", ["--dp", "2"]),
                       ("dp2_fsdp", ["--dp", "2", "--fsdp"])):
        exp = exp_dir(tag)
        mesh_line, secs = command(tag, argv("unfolded_snmf", "data", "test",
                                            exp) + extra)
        got = overall(exp)
        diff = np.abs(got - want)
        tols = np.array((ILL_CONDITIONED_SDR_TOL,) + SCORE_TOLS[1:])
        check(mesh_line is not None and "backend gloo" in mesh_line
              and "2 ranks a card" in mesh_line,
              f"parallel: the CLI {tag} printed the layout {mesh_line}")
        check(bool(np.all(diff <= tols)),
              f"parallel: the CLI {tag}'s overall scores {got} against the "
              f"single process's {want}")
        runs[tag] = {"seconds": secs, "mesh": mesh_line,
                     "overall": dict(zip(SCORE_LABELS, got.tolist())),
                     "max_abs_diff_to_single": diff.tolist()}

    small_single = exp_dir("small_single", cached=False)
    cli.main(argv("unfolded_snmf", "data_small", "", small_single)
             + ["-q", "--dp", "1"])
    small_tp = exp_dir("small_dp2_tp2", cached=False)
    mesh_line, secs = command("dp2_tp2", argv(
        "unfolded_snmf", "data_small", "", small_tp) + ["--dp", "2",
                                                         "--tp", "2"])
    want_loss, got_loss = losses(small_single), losses(small_tp)
    loss_rel = float(np.max(np.abs(np.subtract(got_loss, want_loss))
                            / np.abs(want_loss)))
    check(mesh_line is not None and "dp=2 x tp=2 over 4 ranks" in mesh_line
          and len(got_loss) == len(want_loss) and loss_rel <= PAR_FIT_RTOL,
          f"parallel: the CLI's --dp 2 --tp 2 fit: {mesh_line}, losses "
          f"{got_loss} against {want_loss}")
    runs["dp2_tp2"] = {"seconds": secs, "mesh": mesh_line,
                       "files": n_files, "steps": len(got_loss),
                       "losses": got_loss, "single_losses": want_loss,
                       "max_rel_diff": loss_rel}
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            cli.main(argv("lstm", "data", "test", exp_dir("lstm", False))
                     + ["--tp", "2"])
            refused = False
        except SystemExit:
            refused = True
    check(refused and "--tp applies to the DR-NMF recurrence only"
          in err.getvalue(), "parallel: --tp 2 on an LSTM config ran")
    return {"single_seconds": single_s,
            "single_overall": dict(zip(SCORE_LABELS, want.tolist())),
            "runs": runs, "lstm_tp_refused": err.getvalue().strip()[-80:]}


def parallel_phase(card, config, params, enhanced, clean):
    """Phase ``parallel`` (module docstring).  Returns the launches of the
    multi-rank paths, summed over the ranks."""
    import torch
    from drnmf_torch.metrics import engine
    from drnmf_torch.models import drnmf
    from drnmf_torch.ops.snmf_mu import sparse_nmf_ed
    from drnmf_torch.parallel import run_ranks
    from drnmf_torch.utils.memplan import plan_memory

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    work = os.path.join(root, "parallel")
    os.makedirs(work, exist_ok=True)
    host = {k: v.detach().cpu().numpy() for k, v in params.items()}
    np.savez(os.path.join(work, "flagship.npz"), **host)
    gen = torch.Generator(device="cuda").manual_seed(2019)
    train = train_sequences(gen, PAR_STEPS * TRAIN_BATCH, config)
    valid = train_sequences(gen, PAR_VALID_SEQS, config)
    np.savez(os.path.join(work, "fit_data.npz"), x=train[0], y=train[1],
             mask=train[2], vx=valid[0], vy=valid[1], vmask=valid[2])
    m, r, n = SNMF_TIMES_SHAPE
    v = np.random.default_rng(2020).uniform(0.01, 1.0, (m, n)).astype(
        np.float32)
    np.save(os.path.join(work, "snmf_v.npy"), v)
    snmf_kw = dict(r=r, cf="ed", sparsity=1.0, random_seed=2016)

    # one process: the fit, and sparse NMF's time an iteration
    reset_launches()
    single = parallel_fit(None, "single", config, host, train, valid)

    # the same solver in one process, its iterations timed as the ranks'
    # are (between the divergences)
    marks = []

    def mark(*tensors):
        if len(tensors) == 1:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        return tensors

    gen = torch.Generator(device="cuda").manual_seed(2016)
    sparse_nmf_ed(torch.from_numpy(v).cuda(),
                  torch.rand((m, r), generator=gen, device="cuda"),
                  torch.rand((r, n), generator=gen, device="cuda"),
                  snmf_kw["sparsity"], torch.ones(r, dtype=torch.bool,
                                                  device="cuda"),
                  PAR_SNMF_ITERS, 0.0, reduce_sum=mark)
    snmf_single = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    del v
    want, want_delays = engine.score_all_packed(
        *_pcm16_pair(enhanced, clean), device="cuda")
    ests, refs = _pcm16_pair(enhanced, clean)
    want_ridges = engine.sdr_at_ridges(ests, refs, device="cuda")
    lens = [min(len(e), len(r_)) for e, r_ in zip(ests, refs)]
    conditioning = reference_conditioning(
        [r_[:k] for r_, k in zip(refs, lens)])
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks(parallel_rank, PAR_RANKS,
                      args=(work, config, {"enhanced": enhanced,
                                           "clean": clean}, snmf_kw),
                      device="cuda", timeout_s=PAR_TIMEOUT_S,
                      deadline_s=2 * PAR_TIMEOUT_S)
    group_s = time.perf_counter() - t0

    # (a) every layout against the one process
    trains = drnmf.drnmf_trainable_mask(config, params)
    plan = plan_memory(config, n_dp=PAR_RANKS, fsdp=True)
    fits = {}
    for layout in ("dp", "fsdp", "tp"):
        worst_loss = worst_param = 0.0
        for rank, out in enumerate(ranks):
            res = out[layout]
            for where in ("on_batch_end", "on_epoch_end"):
                for key, ref in single["history"][where].items():
                    got = np.asarray(res["history"][where][key])
                    ref = np.asarray(ref)
                    check(bool(np.all(np.abs(got - ref)
                                      <= PAR_FIT_RTOL * np.abs(ref))),
                          f"parallel: {layout} rank {rank} {where} {key} "
                          f"{got} against {ref}")
                    worst_loss = max(worst_loss, float(np.max(
                        np.abs(got - ref) / np.abs(ref))))
            for k, ref in single["best"].items():
                got = res["best"][k]
                check(bool(np.all(np.abs(got - ref) <= PAR_FIT_ATOL
                                  + PAR_FIT_RTOL * np.abs(ref))),
                      f"parallel: {layout} rank {rank} parameter {k} is "
                      f"{np.abs(got - ref).max()} from the one process's")
                worst_param = max(worst_param,
                                  float(np.abs(got - ref).max()))
            launches = res["launches"]
            if layout == "tp":
                check(only_launched(launches),
                      f"parallel: tp rank {rank} launched {launches}")
            else:
                check(launches["factored"] == PAR_STEPS + 1
                      and launches["factored_backward"] == PAR_STEPS
                      and only_launched(launches, "factored",
                                        "factored_backward"),
                      f"parallel: {layout} rank {rank} launched {launches}")
        resident = [out[layout]["resident"] for out in ranks]
        if layout == "fsdp":
            check(all(rb["params"] + rb["moments"] == plan["total"]
                      for rb in resident),
                  f"parallel: FSDP holds {resident}, plan_memory "
                  f"{plan['total']}")
        fits[layout] = {
            "ms_a_step": [out[layout]["ms_a_step"] for out in ranks],
            "step_ms": [out[layout]["step_ms"] for out in ranks],
            "fit_seconds": [out[layout]["fit_seconds"] for out in ranks],
            "resident_bytes": resident,
            "one_step_collectives": ranks[0][layout]["one_step_collectives"],
            "max_rel_loss_diff": worst_loss,
            "max_abs_param_diff": worst_param,
            "launches": [out[layout]["launches"] for out in ranks]}
    grad_bytes = 4 * sum(int(params[k].numel()) for k in trains
                         if trains[k])
    log("parallel_fit", card=card, backend=ranks[0]["backend"],
        ranks=PAR_RANKS, ranks_per_device=ranks[0]["ranks_per_device"],
        devices=[out["device"] for out in ranks], batch=TRAIN_BATCH,
        frames_a_sequence=TRAIN_T, steps=PAR_STEPS,
        single_ms_a_step=single["ms_a_step"],
        single_step_ms=single["step_ms"],
        single_fit_seconds=single["fit_seconds"], layouts=fits,
        trainable_gradient_bytes=grad_bytes,
        plan_memory_fsdp={"params": plan["params"],
                          "opt_state": plan["opt_state"],
                          "total": plan["total"]},
        plan_memory_replicated=plan_memory(config)["total"])

    # (b) sparse NMF
    snmf = [out["snmf"] for out in ranks]
    for rank, res in enumerate(snmf):
        check(res["n_iter"] == res["ref_n_iter"] == PAR_SNMF_ITERS
              and all(e <= SNMF_RTOL
                      for e in res["max_rel_err_of_max"].values())
              and res["launches"]["pass1"] == PAR_SNMF_ITERS
              and res["launches"]["pass2"] == PAR_SNMF_ITERS
              and only_launched(res["launches"], "pass1", "pass2"),
              f"parallel: sharded SNMF rank {rank}: {res}")
    log("parallel_snmf", card=card, shape=[m, r, n], ranks=PAR_RANKS,
        iterations=PAR_SNMF_ITERS,
        ms_an_iteration=[res["ms_an_iteration"] for res in snmf],
        iteration_ms=[res["iteration_ms"] for res in snmf],
        call_seconds=[res["call_seconds"] for res in snmf],
        single_ms_an_iteration=statistics.median(snmf_single),
        single_iteration_ms=snmf_single,
        max_rel_err_of_max=[res["max_rel_err_of_max"] for res in snmf],
        statistics_bytes_an_iteration=2 * 4 * m * r,
        collective_bytes=[res["collective_bytes"] for res in snmf],
        collectives=[res["collectives"] for res in snmf],
        launches=[res["launches"] for res in snmf])

    # (c) scoring: every rank's table against the one process's engine,
    # each row's SDR by ridge from the batch its rank scored it in
    got_ridges = np.zeros_like(want_ridges)
    for out in ranks:
        got_ridges[out["score"]["rows"]] = out["score"]["ridges"]
    worst = other_ridge = worst_ill = None
    for rank, out in enumerate(ranks):
        sc = out["score"]
        check(np.array_equal(sc["delays"], want_delays),
              f"parallel: sharded scoring rank {rank}: other delays")
        worst, other_ridge, worst_ill = hold_scores(
            sc["S"], want, got_ridges, want_ridges, conditioning)
    audio_s = ranks[0]["score"]["audio_seconds"]
    log("parallel_score", card=card, files=len(enhanced), ranks=PAR_RANKS,
        audio_seconds=audio_s,
        first_seconds=[out["score"]["first_seconds"] for out in ranks],
        warm_seconds=[out["score"]["warm_seconds"] for out in ranks],
        score_rtf_warm=audio_s / max(out["score"]["warm_seconds"]
                                     for out in ranks),
        repeat_bit_equal=[out["score"]["repeat_bit_equal"] for out in ranks],
        max_abs_diff_to_single=dict(zip(("SDR", "SNR", "SegSNR local",
                                         "SegSNR global", "PESQ", "STOI"),
                                        worst)),
        rows_kept_at_another_ridge=other_ridge,
        ill_conditioned_sdr_max_abs_diff=worst_ill)

    # (d) the command line
    t0 = time.perf_counter()
    cli_runs = parallel_cli(card, os.path.join(root, "pipeline"), work)
    log("parallel_cli", card=card, seconds=time.perf_counter() - t0,
        **cli_runs)

    launches = {k: 0 for k in read_launches()}
    for out in ranks:
        for part in (out["dp"]["launches"], out["fsdp"]["launches"],
                     out["snmf"]["launches"]):
            for k, c in part.items():
                launches[k] += c
    log("parallel_done", group_seconds=group_s,
        phase_seconds=time.perf_counter() - t_phase, launches=launches)
    return launches


def pipelined_rank(rank, work, which, config, dense_config):
    """One rank of the ``pipelined`` phase: the sequence-pipelined scan
    (``which`` "seq") or the layer-pipelined scan and the sharded
    checkpoint ("layer"), each case against one process's ``make_scan``
    on the same card, launches counted on the pipelined calls alone."""
    import torch
    from drnmf_torch.device import params_on_device
    from drnmf_torch.models.drnmf import make_scan, step_mask_from_input
    from drnmf_torch.parallel import (drnmf_scan_layer_pipelined,
                                      drnmf_scan_seq_pipelined,
                                      fsdp_shard_params, make_mesh)
    from drnmf_torch.train import save_checkpoint_sharded

    mesh = make_mesh()
    x = torch.from_numpy(np.load(os.path.join(work, f"{which}_x.npy"))).cuda()
    out = {"backend": mesh.backend, "ranks_per_device": mesh.ranks_per_device}
    for kind, cfg in (("frozen_u", config), ("dense_u", dense_config)):
        params = params_on_device(dict(np.load(os.path.join(
            work, f"{kind}.npz"))), "cuda")
        mask = step_mask_from_input(x, cfg.mask_value)
        run = make_scan(params, cfg)
        # one process's call, timed on rank 0 while the others wait
        mesh.barrier()
        one_ms = cuda_ms(lambda: run(x, mask), 2) if rank == 0 else None
        mesh.barrier()
        ref = run(x, mask)
        if which == "seq":
            calls = [(f"G={g}", dict(n_groups=g)) for g in SEQ_GROUPS]
            scan = drnmf_scan_seq_pipelined
        else:
            calls = [("G=P", {})]
            scan = drnmf_scan_layer_pipelined
        for label, kw in calls:
            reset_launches()
            before = (mesh.staged, mesh.calls["world"], mesh.traffic["world"])
            times = []
            with torch.no_grad():
                for i in range(1 + SEQ_CALLS):
                    mesh.barrier()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = scan(params, cfg, x, mask, mesh, **kw)
                    torch.cuda.synchronize()
                    if i:
                        times.append(1e3 * (time.perf_counter() - t0))
            err, rel, ok = compare(got, ref)
            out[kind, label] = {
                "launches": read_launches(), "ms": times,
                "one_process_ms": one_ms, "max_abs_err": err,
                "max_rel_err": rel, "within_tol": ok,
                "bit_equal": bool(torch.equal(got, ref)),
                "staged_bytes": mesh.staged - before[0],
                "collectives": mesh.calls["world"] - before[1],
                "collective_bytes": mesh.traffic["world"] - before[2]}
            del got
        del ref, run
    if which == "layer":
        # the sharded checkpoint: each rank writes its FSDP block of the
        # flagship parameters
        host = dict(np.load(os.path.join(work, "frozen_u.npz")))
        shards, dims = fsdp_shard_params(host, mesh)
        t0 = time.perf_counter()
        import torch.distributed.checkpoint  # noqa: F401
        import_s = time.perf_counter() - t0
        mesh.barrier()
        t0 = time.perf_counter()
        save_checkpoint_sharded(os.path.join(work, "checkpoint"), shards,
                                meta={"step": 7}, mesh=mesh, dims=dims)
        out["checkpoint"] = {"seconds": time.perf_counter() - t0,
                             "import_seconds": import_s, "dims": dims,
                             "shard_bytes": sum(v.numel() * v.element_size()
                                                for v in shards.values())}
    return out


def pipelined_phase(card, config, params):
    """Phase ``pipelined`` (module docstring).  Returns the launches of the
    sequence-pipelined runs, summed over the ranks."""
    import shutil

    import torch
    from drnmf_torch.parallel import run_ranks
    from drnmf_torch.train import load_checkpoint_sharded

    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke", "pipelined")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    dense_config, dense_params = dense_flagship(config, params)
    host = {}
    for kind, p in (("frozen_u", params), ("dense_u", dense_params)):
        host[kind] = {k: v.detach().cpu().numpy() for k, v in p.items()}
        np.savez(os.path.join(work, f"{kind}.npz"), **host[kind])
    del dense_params
    # noisy magnitudes of B signals of T frames; every fourth row ends
    # early (its tail holds the mask value), as a padded utterance does
    gen = torch.Generator(device="cuda").manual_seed(2021)
    _, noisy = synth_magnitudes(gen, SEQ_BATCH, SEQ_T * HOP / FS)
    noisy = noisy[:, :SEQ_T].contiguous()
    check(tuple(noisy.shape) == (SEQ_BATCH, SEQ_T, 257),
          f"pipelined: the input is {tuple(noisy.shape)}")
    for i in range(3, SEQ_BATCH, 4):
        noisy[i, 600 + (53 * i) % 300:] = config.mask_value
    layer_x = noisy[:LAYER_BATCH, :LAYER_T].clone()
    layer_x[3, 20:] = config.mask_value
    np.save(os.path.join(work, "seq_x.npy"), noisy.cpu().numpy())
    np.save(os.path.join(work, "layer_x.npy"), layer_x.cpu().numpy())
    del noisy, layer_x
    torch.cuda.empty_cache()

    groups = {}
    for which, world in (("seq", SEQ_RANKS), ("layer", config.K_layers)):
        t0 = time.perf_counter()
        ranks = run_ranks(pipelined_rank, world,
                          args=(work, which, config, dense_config),
                          device="cuda", timeout_s=PAR_TIMEOUT_S,
                          deadline_s=2 * PAR_TIMEOUT_S)
        groups[which] = (ranks, time.perf_counter() - t0)
    launches = {k: 0 for k in read_launches()}
    for which, (ranks, group_s) in groups.items():
        cases = {}
        for key in ranks[0]:
            if not isinstance(key, tuple):
                continue
            kind, label = key
            kernel = {"seq": {"frozen_u": "factored", "dense_u": "dense"},
                      "layer": {}}[which].get(kind)
            per_rank = [out[key] for out in ranks]
            for rank, res in enumerate(per_rank):
                check(res["within_tol"], f"pipelined: {which} {kind} "
                      f"{label} rank {rank} is {res['max_abs_err']} from "
                      f"one process")
                want_calls = 1 + SEQ_CALLS
                n_groups = (int(label[2:]) if which == "seq" else 0)
                check((kernel is None and only_launched(res["launches"]))
                      or (res["launches"][kernel] == want_calls * n_groups
                          and only_launched(res["launches"], kernel)),
                      f"pipelined: {which} {kind} {label} rank {rank} "
                      f"launched {res['launches']}")
                check(res["staged_bytes"] > 0, f"pipelined: {which} staged "
                      f"nothing through the host on rank {rank}")
                if which == "seq":
                    for k, c in res["launches"].items():
                        launches[k] += c
            cases[f"{kind} {label}"] = {
                "ms_a_call": max(statistics.median(r["ms"])
                                 for r in per_rank),
                "ms_by_rank": [r["ms"] for r in per_rank],
                "one_process_ms": per_rank[0]["one_process_ms"],
                "max_abs_err": max(r["max_abs_err"] for r in per_rank),
                "max_rel_err": max(r["max_rel_err"] for r in per_rank),
                "bit_equal": [r["bit_equal"] for r in per_rank],
                "launches_by_rank": [{k: c for k, c in r["launches"].items()
                                      if c} for r in per_rank],
                "staged_bytes_by_rank": [r["staged_bytes"] for r in per_rank],
                "collectives_by_rank": [r["collectives"] for r in per_rank],
                "collective_bytes_by_rank": [r["collective_bytes"]
                                             for r in per_rank]}
        log(f"pipelined_{which}", card=card, ranks=len(ranks),
            backend=ranks[0]["backend"],
            ranks_per_device=ranks[0]["ranks_per_device"],
            shape=[SEQ_BATCH, SEQ_T] if which == "seq"
            else [LAYER_BATCH, LAYER_T], calls_timed=SEQ_CALLS,
            group_seconds=group_s, cases=cases)
    check(launches["factored"] > 0 and launches["dense"] > 0,
          f"pipelined: the sequence-pipelined runs launched {launches}")

    # one process loads the blocks the five ranks wrote, whole (the
    # module's import timed apart)
    t0 = time.perf_counter()
    import torch.distributed.checkpoint  # noqa: F401
    import_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, meta = load_checkpoint_sharded(os.path.join(work, "checkpoint"))
    load_s = time.perf_counter() - t0
    want = host["frozen_u"]
    check(sorted(loaded) == sorted(want) and meta == {"step": 7}
          and all(np.array_equal(loaded[k].numpy(), want[k]) for k in want),
          "pipelined: the sharded checkpoint does not load back bit-equal")
    ranks = groups["layer"][0]
    files = sorted(os.listdir(os.path.join(work, "checkpoint")))
    log("pipelined_checkpoint", ranks=len(ranks), files=files,
        file_bytes={f: os.path.getsize(os.path.join(work, "checkpoint", f))
                    for f in files},
        sharded=sorted(k for k, d in ranks[0]["checkpoint"]["dims"].items()
                       if d is not None),
        shard_bytes_by_rank=[r["checkpoint"]["shard_bytes"] for r in ranks],
        save_seconds=[r["checkpoint"]["seconds"] for r in ranks],
        import_seconds_by_rank=[r["checkpoint"]["import_seconds"]
                                for r in ranks],
        load_seconds=load_s, load_import_seconds=import_s, bit_equal=True)
    log("pipelined_done", phase_seconds=time.perf_counter() - t_phase,
        launches=launches)
    return launches


def trace_contents(path):
    """(names of the trace's events, its bytes) of a Chrome trace file."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return {e.get("name") or "" for e in events}, os.path.getsize(path)


def write_keras_h5(path, config, params):
    """The flagship's parameters in the reference's Keras 2.0.4
    ``save_weights`` layout (tests/test_convert.py's writer)."""
    import h5py

    rnn = "simple_deep_rnn_1"
    layers = [("masking_1", []),
              (rnn, [(f"{rnn}_{k}", v) for k, v in sorted(params.items())
                     if not k.startswith("log_W_")]),
              ("clean_est", [("clean_est/kernel:0", params["log_W_clean"])]),
              ("noise_est", [("noise_est/kernel:0", params["log_W_noise"])])]
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n, _ in layers])
        for name, weights in layers:
            grp = f.create_group(name)
            grp.attrs["weight_names"] = np.array([w.encode()
                                                  for w, _ in weights])
            for wn, arr in weights:
                grp.create_dataset(wn, data=arr)


def tooling_phase(card, config, params, cfg_path):
    """Phase ``tooling`` (module docstring).  Returns the launches of its
    paths ((a), (b) and (d)'s imported model)."""
    import contextlib
    import importlib.util
    import io
    import shutil

    import torch
    from drnmf_torch import (cli, create_taskfiles, import_reference_weights,
                             plot_learning_curves, print_scores,
                             run_waspaa2017)
    from drnmf_torch.enhance import enhance_signals
    from drnmf_torch.models.drnmf import (factored_scan_operands,
                                          step_mask_from_input)
    from drnmf_torch.ops import drnmf_scan, ista_ed
    from drnmf_torch.train import load_checkpoint

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    pipe, work = (os.path.join(root, d) for d in ("pipeline", "tooling"))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    data_yaml = os.path.join(pipe, "params_data.yaml")
    argv = ["-c", os.path.join(pipe, "params_unfolded_snmf.yaml"), "-d",
            data_yaml, "--exp-dir", os.path.join(pipe, "exp"), "--splits",
            "test", "-q"]

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # (a) --trace on the pipeline phase's cached rerun: alone, traced, and
    # traced over two ranks
    reset_launches()
    plain_s = timed(cli.main, argv)
    traces = {"one": os.path.join(work, "trace"),
              "dp2": os.path.join(work, "trace_dp2")}
    traced_s = timed(cli.main, argv + ["--trace", traces["one"]])
    dp_s = timed(cli.main, argv + ["--dp", "2", "--trace", traces["dp2"]])
    # the ranks of --dp 2 count in their own processes: this one's are the
    # untraced run's, the traced one's and rank 0's predictions
    trace_launches = read_launches()
    check(trace_launches["factored"] > 0,
          f"tooling: the cached reruns launched {trace_launches}")
    stages = {"dictionary", "load_tensors:test"}
    rank0_stages = stages | {"predict_irm:test", "reconstruct:test"}
    files = {}
    for label, d in traces.items():
        want = ["trace_rank0.json"] + (["trace_rank1.json"]
                                       if label == "dp2" else [])
        tallies = [n.replace("trace_", "spans_") for n in want]
        check(sorted(os.listdir(d)) == sorted(want + tallies),
              f"tooling: --trace wrote {os.listdir(d)} for {label}")
        for name in tallies:
            with open(os.path.join(d, name)) as fh:
                spans = set(json.load(fh)["spans"])
            check(stages <= spans, f"tooling: {label}/{name} lacks stage "
                  f"spans")
        for name in want:
            names, size = trace_contents(os.path.join(d, name))
            first = name == "trace_rank0.json"
            has_b1 = any(B1_SYMBOL in n for n in names)
            files[f"{label}/{name}"] = {
                "bytes": size, "events": len(names),
                "stages": sorted(n for n in names
                                 if n in rank0_stages | {"score:test"}),
                "b1": has_b1}
            check((rank0_stages if first else stages) <= names,
                  f"tooling: {label}/{name} lacks stage names")
            # rank 0 alone predicts in a cached run
            check(has_b1 or not first, f"tooling: {label}/{name} holds no "
                  f"{B1_SYMBOL}")
    log("tooling_trace", card=card, untraced_seconds=plain_s,
        traced_seconds=traced_s, traced_dp2_seconds=dp_s, files=files,
        launches=trace_launches)

    # (b) the experiment scripts: the flagship pair of the demo grid
    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        reset_launches()
        with contextlib.redirect_stdout(out):
            waspaa_s = timed(run_waspaa2017.main, [
                "--data-config", data_yaml, "--demo", "--demo-epochs", "1",
                "--only", "2,10"])
        script_launches = read_launches()
        setup = os.path.join(work, "data_setup_downsample1")
        tables = {}
        for label, args in (("plain", [setup]),
                            ("per_snr", [setup, "--per-snr"]),
                            ("curves", [setup, "--out",
                                        os.path.join(work, "curves.png")])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                (plot_learning_curves if label == "curves"
                 else print_scores).main(args)
            tables[label] = buf.getvalue().splitlines()
    finally:
        os.chdir(cwd)
    summary = out.getvalue().splitlines()
    summary = summary[summary.index(
        next(line for line in summary if line.startswith("== data_setup")
             and line.endswith("results"))):]
    check(all(script_launches[k] > 0 for k in (
        "pass1", "pass2", "factored", "factored_backward")),
          f"tooling: run_waspaa2017 launched {script_launches}")
    # the table lists the grid's ten configs; the two that ran are scored
    scored = [line.split()[:3] for line in tables["plain"][2:]
              if line.split()[-2:] != ["-", "-"]]
    check(len(tables["plain"]) == 12 and sorted(scored) == [
        ["snmf", "-", "2000"], ["unfolded_snmf", "5", "2000"]],
          f"tooling: print_scores printed {tables['plain']}")
    matplotlib = importlib.util.find_spec("matplotlib") is not None
    check(os.path.isfile(os.path.join(work, "curves.png")) if matplotlib
          else "matplotlib unavailable; curve data:" in tables["curves"],
          f"tooling: plot_learning_curves printed {tables['curves']}")
    # create_taskfiles on a CHiME2-shaped tree of links to the corpus
    with open(os.path.join(pipe, "params_data.yaml")) as fh:
        import yaml
        data = yaml.safe_load(fh)
    chime2 = os.path.join(work, "chime2")
    links = {}
    for split, subset in create_taskfiles.SPLITS.items():
        for cond, tree in create_taskfiles.CONDITIONS.items():
            side = "x" if cond == "noisy" else "y"
            with open(data[f"taskfile_{side}_{split}"]) as fh:
                wavs = fh.read().split()
            base = os.path.commonpath(wavs)
            made = []
            for wav in wavs:
                link = os.path.join(chime2, tree, subset,
                                    os.path.relpath(wav, base))
                os.makedirs(os.path.dirname(link), exist_ok=True)
                os.symlink(wav, link)
                made.append(link)
            links[f"{split}_{cond}"] = sorted(made)
    with contextlib.redirect_stdout(io.StringIO()):
        written = create_taskfiles.main([chime2, "--out-dir",
                                         os.path.join(work, "taskfiles")])
    for key, path in written.items():
        with open(path) as fh:
            check(fh.read().split() == links[key],
                  f"tooling: create_taskfiles' {key} list differs")
    log("tooling_scripts", card=card, run_waspaa2017_seconds=waspaa_s,
        launches=script_launches, summary=summary,
        print_scores=tables["plain"], print_scores_per_snr=tables["per_snr"],
        matplotlib=matplotlib, plot_learning_curves=tables["curves"],
        taskfiles={k: len(v) for k, v in links.items()})
    launches = {k: trace_launches[k] + script_launches[k]
                for k in trace_launches}

    # (c) ISTA on the card against the CPU, and as B1's layer stack: a
    # flagship with every layer active (alph 2000) and log_Uk at -80, so
    # U_k's leak vanishes and layers 1..K-1 are ISTA steps
    from drnmf_torch.models.drnmf import _effective_matrices
    gen = torch.Generator(device="cuda").manual_seed(2022)
    _, noisy = synth_magnitudes(gen, 4, 4096 * HOP / FS / 4)
    frames = noisy.reshape(-1, 257)[:4096].T.contiguous()
    _, _, w_layers, _ = _effective_matrices(params, config)
    w = (w_layers[0] * torch.exp(params["log_alph_0"])).contiguous()
    h = torch.rand((2000, 4096), generator=gen, device="cuda") * 0.01
    lam1 = float(torch.exp(params["log_lam1"]))
    alph = float(torch.exp(params["log_alph_0"]))
    card_h = ista_ed(frames, w, h, lam1, alph, 5)
    cpu_h = ista_ed(frames.cpu(), w.cpu(), h.cpu(), lam1, alph, 5)
    ista_err, _, ista_ok = compare(card_h.cpu(), cpu_h)
    check(ista_ok, f"tooling: ista_ed on the card is {ista_err} from the "
          f"CPU")
    ista_ms = cuda_ms(lambda: ista_ed(frames, w, h, lam1, alph, 5), 3)
    live_config, live = live_flagship(config, params)
    live["log_Uk"] = torch.full_like(live["log_Uk"], -80.0)
    x = synth_magnitudes(gen, 32, 0.1)[1][:, :1].contiguous()
    args = factored_scan_operands(live, live_config, x, step_mask_from_input(
        x, live_config.mask_value))
    _, h_all = drnmf_scan.drnmf_scan_factored(*args, keep_layers=True)
    _, _, w_live, _ = _effective_matrices(live, live_config)
    names = live_config.untied_names("log_alph")
    steps = []
    for k in range(1, live_config.K_layers):
        a_k = torch.exp(live[names[k]])
        got = h_all[k, :, 0, :32]
        want = ista_ed(x[:, 0].T, w_live[k] * a_k, h_all[k - 1, :, 0, :32],
                       torch.exp(live["log_lam1"]), a_k, 1)
        err = (got - want).abs().max().item()
        peak = want.abs().max().item()
        steps.append({"layer": k, "max_abs_err": err, "peak": peak,
                      "active_share": (got > 0).float().mean().item()})
        check(err <= KERNEL_RTOL * peak + KERNEL_ATOL and peak > 0,
              f"tooling: B1's layer {k} is {err} from an ISTA step "
              f"(peak {peak})")
    log("tooling_ista", card=card, shape=[257, 2000, 4096], steps=5,
        max_abs_err_to_cpu=ista_err, ms=ista_ms, identity=steps)
    del card_h, cpu_h, h, h_all, noisy

    # (d) the Keras import, where h5py is installed
    if importlib.util.find_spec("h5py") is None:
        log("tooling", h5py=False)
    else:
        h5 = os.path.join(work, "model_unfolded_snmf_flagship.hdf5")
        host = {k: v.detach().cpu().numpy() for k, v in params.items()}
        write_keras_h5(h5, config, host)
        npz = os.path.join(work, "model_unfolded_snmf_flagship.npz")
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            import_reference_weights.main([h5, "-o", npz, "-c", cfg_path])
        imported, _ = load_checkpoint(npz)
        signals = synth_signals(np.random.default_rng(3), 4, 4.0)
        reset_launches()
        got = enhance_signals(imported, config, signals, N_FFT, HOP)
        for k, c in read_launches().items():
            launches[k] += c
        want = enhance_signals(params, config, signals, N_FFT, HOP)
        check(sorted(imported) == sorted(host)
              and all(np.array_equal(imported[k], host[k]) for k in host)
              and all(np.array_equal(a, b) for a, b in zip(got, want)),
              "tooling: the imported model differs from the original")
        log("tooling_keras", h5py=True, printed=buf.getvalue().splitlines(),
            tensors=len(imported), enhanced_bit_equal=True)
    log("tooling_done", phase_seconds=time.perf_counter() - t_phase,
        launches=launches)
    return launches


def _pcm16_pair(enhanced, clean):
    """The enhanced and clean wavs as PCM16 arrays (the native reader)."""
    from drnmf_torch.data.native_loader import read_batch_i16

    out = []
    for paths in (enhanced, clean):
        x, lens = read_batch_i16(paths)
        out.append([x[i, :lens[i]] for i in range(len(paths))])
    return out


def main():
    import torch

    # 1. device
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device", card=card, kind=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    t_start = time.perf_counter()

    from drnmf_torch.device import resolve_device
    from drnmf_torch.dsp.wav import wavwrite
    from drnmf_torch.enhance import enhance_signals, stage_clock
    from drnmf_torch.ops import build, drnmf_scan, snmf_mu

    resolve_device("cuda")

    # 2. build, one nvcc per source, all started together
    t0 = time.perf_counter()
    sources = (drnmf_scan.SOURCE, drnmf_scan.INTERLEAVED_SOURCE,
               drnmf_scan.DENSE_SOURCE, drnmf_scan.BACKWARD_SOURCE,
               snmf_mu.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(build.build, sources))
    drnmf_scan._library()
    drnmf_scan._interleaved_library()
    drnmf_scan._dense_library()
    drnmf_scan._backward_library()
    snmf_mu._library()
    for source, lib in zip(sources, built):
        log("build", seconds=time.perf_counter() - t0, library=str(lib.name),
            ptxas=[line.strip() for line in
                   build.build_log(source).splitlines()
                   if "registers" in line or "spill" in line
                   or "Compiling entry" in line])

    # 3. main path, through the entry points, at full width
    config, params = flagship()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke")
    os.makedirs(work, exist_ok=True)
    cfg_path, ckpt = save_model(work, "flagship", config, params)
    wavs = []
    for i, s in enumerate(synth_signals(np.random.default_rng(1), 3, 3.0)):
        wavs.append(os.path.join(work, f"noisy{i}.wav"))
        wavwrite(wavs[-1], FS, s[None])
    batch = [s for s in (0.1 * np.random.default_rng(2).standard_normal(
        (256, FS * 8))).astype(np.float32)]
    main_launches, rtf = enhance_main("main", card, config, params, cfg_path,
                                      ckpt, wavs, batch, "factored",
                                      n_calls=5, n_warm=2)

    # 4. times at the main path's shapes (B=256, T=1021)
    for _ in range(2):  # the second call is warm
        stages = {}
        enhance_signals(params, config, batch, N_FFT, HOP, batch_size=256,
                        lap=stage_clock(stages, "cuda"))
    log("stages", card=card, seconds=stages,
        seconds_total=sum(stages.values()))
    mag = main_path_magnitudes(batch)
    args = scan_operands(config, params, mag)
    out = drnmf_scan.drnmf_scan_factored(*args)
    inter = drnmf_scan.drnmf_scan_factored(*args, interleave=True)
    ref = drnmf_scan.drnmf_scan_factored_reference(*args)
    torch.cuda.synchronize()
    err, rel, ok = compare(out, ref)
    b2_err, b2_rel, b2_ok = compare(inter, ref)
    b2_vs_b1 = (inter - out).abs().max().item()
    check(ok, "B1 disagrees with its plain version at the main path's shape")
    check(b2_ok and compare(inter, out)[2],
          "B2 disagrees with its plain version or B1 at the main path's shape")
    del ref
    # fixed summation order: a repeat is bit-equal, and a row's bits do not
    # depend on the rows it runs with (B1); B2's sums run in the same order
    # in any batch, whether the tensor cores give a row the same bits at
    # another batch tile is read here (reported), within the tolerance held
    repeat_equal = bool(torch.equal(drnmf_scan.drnmf_scan_factored(*args),
                                    out))
    b2_repeat_equal = bool(torch.equal(drnmf_scan.drnmf_scan_factored(
        *args, interleave=True), inter))
    check(b2_repeat_equal, "a repeat of B2 at the main path's shape differs")

    def rows(sel):
        return [a[sel].contiguous() if i < 3 else a
                for i, a in enumerate(args)]

    b2_rows = {}
    for label, sel in [("0-63", slice(0, STREAMS))] + [
            (str(r), slice(r, r + 1)) for r in (0, STREAMS - 1,
                                                 len(batch) - 1)]:
        alone = drnmf_scan.drnmf_scan_factored(*rows(sel), interleave=True)
        rows_err, _, rows_ok = compare(alone, inter[sel])
        b2_rows[label] = {"bit_equal": bool(torch.equal(alone, inter[sel])),
                          "max_abs_diff": rows_err, "within_tol": rows_ok}
        check(rows_ok, f"B2's rows {label} alone disagree with the batch")
    del inter, alone

    row_bits_equal = bool(torch.equal(
        drnmf_scan.drnmf_scan_factored(*rows(slice(0, STREAMS))),
        out[:STREAMS])) and all(
            torch.equal(drnmf_scan.drnmf_scan_factored(
                *rows(slice(r, r + 1))), out[r:r + 1])
            for r in (0, STREAMS - 1, len(batch) - 1))
    check(repeat_equal, "a repeat of B1 at the main path's shape differs")
    check(row_bits_equal, "a row of B1 differs when run with other rows")
    del out
    # B1, B2, B2, B1 in turns; each figure the mean of its two readings
    b1_a = cuda_ms(lambda: drnmf_scan.drnmf_scan_factored(*args), 2)
    b2_a = cuda_ms(lambda: drnmf_scan.drnmf_scan_factored(
        *args, interleave=True), 2)
    b2_b = cuda_ms(lambda: drnmf_scan.drnmf_scan_factored(
        *args, interleave=True), 2)
    b1_b = cuda_ms(lambda: drnmf_scan.drnmf_scan_factored(*args), 2)
    ms, b2_ms = (b1_a + b1_b) / 2, (b2_a + b2_b) / 2
    plain_ms = cuda_ms(
        lambda: drnmf_scan.drnmf_scan_factored_reference(*args), 3)
    bounds = factored_call_bounds(args)
    stream_args = scan_operands(config, params, mag[:STREAMS, :MULTI_BLOCK]
                                .contiguous())
    stream_ms = {
        "b1": cuda_ms(lambda: drnmf_scan.drnmf_scan_factored(*stream_args), 20),
        "b2": cuda_ms(lambda: drnmf_scan.drnmf_scan_factored(
            *stream_args, interleave=True), 20),
        "plain": cuda_ms(lambda: drnmf_scan.drnmf_scan_factored_reference(
            *stream_args), 5)}
    stream_bounds = factored_call_bounds(stream_args)
    one_args = scan_operands(config, params, mag[:1].contiguous())
    one_ms = cuda_ms(lambda: drnmf_scan.drnmf_scan_factored(*one_args), 3)
    one_b2_ms = cuda_ms(lambda: drnmf_scan.drnmf_scan_factored(
        *one_args, interleave=True), 3)
    # B1 and B2 against the plain version and B2 against B1 at the online
    # paths' shapes: a block of the multi-client step, one row
    small_errs, b2_vs_b1_small = {}, {}
    for key, a in (("64x16", stream_args), ("1x1021", one_args)):
        small_ref = drnmf_scan.drnmf_scan_factored_reference(*a)
        small_b1 = drnmf_scan.drnmf_scan_factored(*a)
        small_b2 = drnmf_scan.drnmf_scan_factored(*a, interleave=True)
        small_errs[key] = {name: compare(o, small_ref)[:2] for name, o in
                           (("b1", small_b1), ("b2", small_b2))}
        check(compare(small_b1, small_ref)[2],
              f"B1 disagrees with its plain version at {key}")
        check(compare(small_b2, small_ref)[2],
              f"B2 disagrees with its plain version at {key}")
        b2_small_err, _, b2_small_ok = compare(small_b2, small_b1)
        b2_vs_b1_small[key] = {"max_abs_diff": b2_small_err,
                               "within_tol": b2_small_ok}
        check(b2_small_ok, f"B2 disagrees with B1 at {key}")
    del small_ref, small_b1, small_b2
    b1, b2 = {}, {}
    for key, a, b1_ms, b2_call_ms in (
            ("256x1021", args, ms, b2_ms),
            ("64x16", stream_args, stream_ms["b1"], stream_ms["b2"]),
            ("1x1021", one_args, one_ms, one_b2_ms)):
        b1[key] = b1_plan_and_rates(a, b1_ms)
        b2[key] = b2_plan_and_rates(a, b2_call_ms)
    check(all(v["share_of_bound"] <= 1.0 for v in b1.values()),
          f"B1 reads faster than its bound: {b1}")
    # the f32 CUDA-core figure is no bound of a tensor-core kernel: only
    # the other two may not be beaten
    check(all(v["share_of_bound"] <= 1.0 and v["share_of_3xtf32_bound"] <= 1.0
              for v in b2.values()), f"B2 reads faster than its bound: {b2}")
    log("times", card=card, shape=list(mag.shape), b1_ms=ms, b2_ms=b2_ms,
        b1_ms_runs=[b1_a, b1_b], b2_ms_runs=[b2_a, b2_b], plain_ms=plain_ms,
        **{key: bounds[key] for key in BOUND_KEYS}, max_abs_err=err,
        max_rel_err=rel, b2_max_abs_err=b2_err, b2_max_rel_err=b2_rel,
        b2_max_abs_diff_to_b1=b2_vs_b1, b1_repeat_bit_equal=repeat_equal,
        b1_row_bits_equal=row_bits_equal, b2_repeat_bit_equal=b2_repeat_equal,
        b2_rows_alone=b2_rows, small_errs_vs_plain=small_errs,
        b2_vs_b1_small=b2_vs_b1_small,
        streaming_shape=[STREAMS, MULTI_BLOCK], streaming_ms=stream_ms,
        streaming_bound_ms=stream_bounds["bound_ms"],
        streaming_bound_by=stream_bounds["bound_by"],
        one_row_ms=one_ms, one_row_b2_ms=one_b2_ms, b1=b1, b2=b2, rtf=rtf)
    del args, stream_args, one_args

    # 5. the dense-U route through the same entry points
    dense_config, dense_params = dense_flagship(config, params)
    dense_cfg_path, dense_ckpt = save_model(work, "flagship_dense_u",
                                            dense_config, dense_params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enhance_signals(dense_params, dense_config, batch, N_FFT, HOP,
                    batch_size=256)  # also warms B3 at this shape
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    # 256 signals a call if a call stays within a few seconds, else 64
    dense_batch = batch if first_call_s <= 6.0 else batch[:64]
    log("dense_batch", first_call_seconds=first_call_s,
        batch=len(dense_batch), limit_seconds=6.0)
    dense_launches, dense_rtf = enhance_main(
        "dense_main", card, dense_config, dense_params, dense_cfg_path,
        dense_ckpt, wavs, dense_batch, "dense", n_calls=3, n_warm=1)
    dense_mag = mag[:len(dense_batch)].contiguous()
    del mag
    args = scan_operands(dense_config, dense_params, dense_mag)
    out = drnmf_scan.drnmf_scan_dense(*args)
    ref = drnmf_scan.drnmf_scan_dense_reference(*args)
    torch.cuda.synchronize()
    b3_err, b3_rel, ok = compare(out, ref)
    check(ok, "B3 disagrees with its plain version at the main path's shape")
    del ref
    # no atomics, the stretches fixed by (F, 2r): a repeat is bit-equal; a
    # row's sums run in the same order in any batch, whether the tensor
    # cores give it the same bits at another instruction width is read
    # here (reported), and it must agree within the kernel tolerance
    b3_repeat_equal = bool(torch.equal(drnmf_scan.drnmf_scan_dense(*args),
                                       out))
    check(b3_repeat_equal, "a repeat of B3 at the main path's shape differs")

    def dense_rows(sel):
        return [a[sel].contiguous() if i < 3 else a
                for i, a in enumerate(args)]

    b3_rows = {}
    n_rows = len(dense_batch)
    for label, sel in [("0-63", slice(0, min(STREAMS, n_rows)))] + [
            (str(r), slice(r, r + 1)) for r in (0, STREAMS - 1, n_rows - 1)]:
        alone = drnmf_scan.drnmf_scan_dense(*dense_rows(sel))
        rows_err, _, rows_ok = compare(alone, out[sel])
        b3_rows[label] = {"bit_equal": bool(torch.equal(alone, out[sel])),
                          "max_abs_diff": rows_err, "within_tol": rows_ok}
        check(rows_ok, f"B3's rows {label} alone disagree with the batch")
    del out, alone
    # plain, B3, B3, plain in turns
    p_a = cuda_ms(lambda: drnmf_scan.drnmf_scan_dense_reference(*args), 1)
    b3_a = cuda_ms(lambda: drnmf_scan.drnmf_scan_dense(*args), 2)
    b3_b = cuda_ms(lambda: drnmf_scan.drnmf_scan_dense(*args), 2)
    p_b = cuda_ms(lambda: drnmf_scan.drnmf_scan_dense_reference(*args), 1)
    b3_ms, b3_plain_ms = (b3_a + b3_b) / 2, (p_a + p_b) / 2
    b3_bounds_main = dense_call_bounds(args)
    stream_args = scan_operands(dense_config, dense_params,
                                dense_mag[:STREAMS, :MULTI_BLOCK].contiguous())
    dense_stream_ms = {
        "b3": cuda_ms(lambda: drnmf_scan.drnmf_scan_dense(*stream_args), 20),
        "plain": cuda_ms(lambda: drnmf_scan.drnmf_scan_dense_reference(
            *stream_args), 5)}
    dense_stream_bound = dense_call_bounds(stream_args)
    one_args = scan_operands(dense_config, dense_params,
                             dense_mag[:1].contiguous())
    one_ms = cuda_ms(lambda: drnmf_scan.drnmf_scan_dense(*one_args), 3)
    # B3 against the plain version at the online paths' shapes
    b3_small_errs = {}
    for key, a in (("64x16", stream_args), ("1x1021", one_args)):
        small_err, small_rel, small_ok = compare(
            drnmf_scan.drnmf_scan_dense(*a),
            drnmf_scan.drnmf_scan_dense_reference(*a))
        b3_small_errs[key] = [small_err, small_rel]
        check(small_ok, f"B3 disagrees with its plain version at {key}")
    b3 = {}
    for key, a, b3_call_ms in ((f"{n_rows}x1021", args, b3_ms),
                               ("64x16", stream_args, dense_stream_ms["b3"]),
                               ("1x1021", one_args, one_ms)):
        b3[key] = b3_plan_and_rates(a, b3_call_ms)
    # the f32 CUDA-core figure is no bound of a tensor-core kernel: only
    # the other two may not be beaten
    check(all(v["share_of_bound"] <= 1.0 and v["share_of_3xtf32_bound"] <= 1.0
              for v in b3.values()), f"B3 reads faster than its bound: {b3}")
    log("dense_times", card=card, shape=list(dense_mag.shape), b3_ms=b3_ms,
        b3_ms_runs=[b3_a, b3_b], plain_ms=b3_plain_ms,
        plain_ms_runs=[p_a, p_b],
        **{key: b3_bounds_main[key] for key in BOUND_KEYS},
        max_abs_err=b3_err, max_rel_err=b3_rel,
        b3_repeat_bit_equal=b3_repeat_equal, b3_rows_alone=b3_rows,
        small_errs_vs_plain=b3_small_errs,
        streaming_shape=[STREAMS, MULTI_BLOCK], streaming_ms=dense_stream_ms,
        streaming_bound_ms=dense_stream_bound["bound_ms"],
        streaming_bound_by=dense_stream_bound["bound_by"],
        one_row_ms=one_ms, b3=b3, rtf=dense_rtf)
    del args, stream_args, one_args, dense_mag

    # 6. the online path
    stream_phase(card, "frozen_u", config, params, "factored")
    stream_phase(card, "dense_u", dense_config, dense_params, "dense")
    multi_launches = {
        "multi_frozen_u": multi_phase(card, "frozen_u", config, params,
                                      "factored", 4.0),
        "multi_frozen_u_interleaved": multi_phase(
            card, "frozen_u_interleaved", config, params, "interleaved", 2.0,
            scan_fn=functools.partial(drnmf_scan.drnmf_scan_factored,
                                      interleave=True)),
        "multi_dense_u": multi_phase(card, "dense_u", dense_config,
                                     dense_params, "dense", 2.0)}
    serve_launches = serve_phase(card, config, params, cfg_path, ckpt)
    paced_launches = paced_phase(card, config, params)
    del dense_params

    # 7. training at the reference schedule
    train_launches, backward_row = train_phase(card, config, params)

    # 8. the experiment pipeline through its command line
    pipeline_launches, enhanced, noisy, clean = pipeline_phase(card)

    # 9. scoring on the card: the pipeline's test split, its noisy input
    # and bench.py's battery, against the CPU
    score_phase(card, enhanced, noisy, clean)

    snmf_rows = snmf_phases(card, config)

    # 14. multi-rank paths: two ranks of one gloo group on the card
    parallel_launches = parallel_phase(card, config, params, enhanced, clean)

    # 15. the pipelined scans and the sharded checkpoint
    pipelined_launches = pipelined_phase(card, config, params)

    # 16. --trace, the experiment scripts, ISTA and the Keras import
    tooling_launches = tooling_phase(card, config, params, cfg_path)

    def by_path(kernel):
        paths = {"main": main_launches, "dense_main": dense_launches,
                 **multi_launches, "serve": serve_launches,
                 "paced": paced_launches, "train": train_launches,
                 "pipeline": pipeline_launches,
                 "parallel": parallel_launches,
                 "pipelined": pipelined_launches,
                 "tooling": tooling_launches}
        return {path: counts[kernel] for path, counts in paths.items()
                if counts[kernel]}

    scan_rows = [{
        "name": "drnmf_scan_factored",
        "route": "cuda",
        "source": "drnmf_torch/ops/csrc/drnmf_scan_factored.cu",
        "replaces": "drnmf_tpu/ops/pallas/drnmf_scan.py:169",
        "launches": main_launches["factored"],
        "launches_by_path": by_path("factored"),
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        **{key: bounds[key] for key in BOUND_KEYS},
        "library_ms": None,
    }, {
        "name": "drnmf_scan_factored_interleaved",
        "route": "cuda",
        "source": "drnmf_torch/ops/csrc/drnmf_scan_factored_interleaved.cu",
        "replaces": "drnmf_tpu/ops/pallas/drnmf_scan.py:213",
        "launches": multi_launches["multi_frozen_u_interleaved"]["interleaved"],
        "launches_by_path": by_path("interleaved"),
        "max_abs_err": b2_err,
        "ms": b2_ms,
        "plain_ms": plain_ms,
        **{key: bounds[key] for key in BOUND_KEYS},
        "library_ms": None,
    }, {
        "name": "drnmf_scan_dense",
        "route": "cuda",
        "source": "drnmf_torch/ops/csrc/drnmf_scan_dense.cu",
        "replaces": "drnmf_tpu/ops/pallas/drnmf_scan.py:48",
        "launches": dense_launches["dense"],
        "launches_by_path": by_path("dense"),
        "max_abs_err": b3_err,
        "ms": b3_ms,
        "plain_ms": b3_plain_ms,
        **{key: b3_bounds_main[key] for key in BOUND_KEYS},
        "library_ms": None,
    }, {**backward_row, "launches_by_path": by_path("factored_backward")}]
    # the scored pipeline's dictionary stage and SNMF run, and the other
    # paths: launches of either route
    for row in snmf_rows:
        for path, counts in (("pipeline", pipeline_launches),
                             ("parallel", parallel_launches),
                             ("pipelined", pipelined_launches),
                             ("tooling", tooling_launches)):
            row["launches_by_path"][path] = counts[
                row["name"].replace("snmf_mu_", "")]
    check(all(row["launches"] > 0 for row in scan_rows + snmf_rows),
          "a kernel was launched on no path")
    check(all(parallel_launches[k] > 0 for k in (
        "factored", "factored_backward", "pass1", "pass2")),
          f"the parallel paths launched {parallel_launches}")
    log("done", seconds_after_device_phase=time.perf_counter() - t_start)
    print(json.dumps({"kernels": scan_rows + snmf_rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
