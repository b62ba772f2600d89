"""Scoring of wav pairs with a cache (counterpart of
``drnmf_tpu/metrics/scoring.py``).

Replaces the reference's MATLAB subprocess stack (score_audio.m:1-239
invoked through audio_dataset.py:399-435): reads enhanced/reference wav
pairs, truncates each to the common length, computes [SDR, SNR, SegSNR
local, SegSNR global, PESQ, STOI] a file, caches the result (.npz, the
JAX package's keys, so either package reads the other's file) and
aggregates by SNR condition as the reference driver does
(enhance.py:1396-1433: raw scores summed over the SNR buckets, divided by
the total file count).

Where the reference ran a MATLAB ``parfor`` over files
(score_audio.m:72-98), 16 kHz corpora go through the engine
(``engine.score_all_packed``): every file decoded as raw PCM16 by the
native reader, one packed transfer and one pass a power-of-two bucket on
the device.  Other single-rate corpora take the packed SDR/SNR/SegSNR and
STOI passes with PESQ on a host thread pool; mixed rates and hosts
without the native reader score file by file.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..device import resolve_device
from ..dsp.wav import wavread_fs
from .pesq import pesq_16k
from .stoi import stoi

SCORE_LABELS = ["SDR", "SNR", "SegSNR local", "SegSNR global", "PESQ", "STOI"]
# the SNR conditions of the corpus, each a path component '/<snr>/'
SNRS = ["m6dB", "m3dB", "0dB", "3dB", "6dB", "9dB"]


def _apply_alignment(xest, xref, fs, align):
    """Pre-align one pair for the per-file scoring paths (the packed
    engine compensates on the device; these paths compensate on the host
    with the same estimators, so the align semantics do not depend on the
    path a corpus takes).  'guard': constant compensation when the
    unbounded host estimate is nonzero; 'full': P.862-style per-utterance
    alignment; 'off': as given.  Estimates that leave <512 overlapping
    samples are treated as spurious (the engine's guard)."""
    if align == "off":
        return xest, xref
    from .align import align_pair, compensate_piecewise, estimate_delay

    n = min(len(xest), len(xref))
    xest, xref = xest[:n], xref[:n]
    if align == "guard":
        d = estimate_delay(xest, xref, fs).d
        if d == 0:
            return xest, xref
        utts, uds = [(0, n)], [d]
    else:
        utts, uds, _ = align_pair(xest, xref, fs)
        if all(d == 0 for d in uds):
            return xest, xref
    if max(abs(d) for d in uds) >= n - 512:
        return xest, xref  # spurious estimate; keep the unshifted pair
    print(f"  WARNING: compensating delay(s) {uds} before scoring")
    return compensate_piecewise(np.asarray(xest, np.float32),
                                np.asarray(xref, np.float32), utts, uds)


def _score_pair(xest, xref, fs, compute_pesq=True, device="cuda"):
    """Scores of one time-aligned pair (score_audio.m:177-238: truncated
    to the common length first): SDR/SNR/SegSNR in one device pass, PESQ
    by the host model, STOI with its host stage."""
    from .fused import fused_device_metrics

    n = min(len(xest), len(xref))
    xest, xref = xest[:n], xref[:n]
    sdr, raw_snr, loc, glo = fused_device_metrics(xest, xref, fs,
                                                  device=device)
    pesq_mos = pesq_16k(xref, xest, fs, compute=compute_pesq)
    stoi_score = stoi(xref, xest, fs, device=device)
    return np.array([sdr, raw_snr, loc, glo, pesq_mos, stoi_score])


def compute_scores(est_file, ref_file, compute_pesq=True, align="guard",
                   device="cuda"):
    """Scores of one file pair."""
    xest, fs_est = wavread_fs(est_file)
    xref, fs_ref = wavread_fs(ref_file)
    if fs_est != fs_ref:
        raise ValueError(f"fs mismatch: {fs_est} vs {fs_ref}")
    xe, xr = _apply_alignment(xest[0], xref[0], fs_est, align)
    return _score_pair(xe, xr, fs_est, compute_pesq=compute_pesq,
                       device=device)


def score_taskfiles(enhanced_files, reference_files, savefile=None,
                    compute_pesq=True, flag_rescore=False, n_workers=8,
                    verbose=False, align="guard", device="cuda"):
    """Score a list of file pairs on ``device``, with a cache.  Returns
    (S, labels): S is (n_files, 6).

    ``align``: "guard" (default: the mask pipeline emits sample-aligned
    pairs) compensates a constant delay where one is detected; "full" runs
    the P.862-style unbounded + per-utterance host alignment on every pair
    (the general scorer, ``python -m drnmf_torch.score_audio``); "off"
    scores the pairs as given.  Every path honours it: the engine
    compensates on the device, the other paths pre-align on the host with
    the same estimators (:func:`_apply_alignment`).  The cache records the
    align mode it was scored under (files without the field count as
    "guard"); another mode rescores."""
    device = resolve_device(device)
    if savefile is not None and os.path.isfile(savefile) and not flag_rescore:
        data = np.load(savefile)
        cached_align = (str(data["align"]) if "align" in data.files
                        else "guard")
        if cached_align == align:
            return data["S"], list(SCORE_LABELS)
        print(f"  rescoring {os.path.basename(savefile)}: cached under "
              f"align='{cached_align}', requested '{align}'")

    pairs = list(zip(enhanced_files, reference_files))

    from ..data.native_loader import native_available

    if native_available() and len(pairs) > 1:
        from ..data.native_loader import read_batch, read_batch_i16, wav_info

        # the per-pair sample-rate check of the scipy path (header reads)
        fs_ref = [wav_info(p)[2] for p in reference_files]
        fs_enh = [wav_info(p)[2] for p in enhanced_files]
        for i, (fr, fe) in enumerate(zip(fs_ref, fs_enh)):
            if fr != fe:
                raise ValueError(
                    f"fs mismatch: {fe} vs {fr} for {enhanced_files[i]}")

        engine_path = len(set(fs_ref)) == 1 and fs_ref[0] == 16000
        read = read_batch_i16 if engine_path else read_batch
        enh_data, enh_len = read(list(enhanced_files))
        ref_data, ref_len = read(list(reference_files))
        ests = [enh_data[i, : enh_len[i]] for i in range(len(pairs))]
        refs = [ref_data[i, : ref_len[i]] for i in range(len(pairs))]

        if engine_path:
            # raw PCM16 to the engine: all six metrics on the device, one
            # packed transfer a bucket, the delay guard included
            from .engine import score_all_packed

            S, _ = score_all_packed(ests, refs, fs_ref[0],
                                    compute_pesq=compute_pesq, align=align,
                                    device=device)
            scores = list(S)
        elif len(set(fs_ref)) == 1:
            from .fused import fused_metrics_packed
            from .stoi import stoi_packed

            if align != "off":
                aligned = [_apply_alignment(ests[i], refs[i], fs_ref[i],
                                            align)
                           for i in range(len(pairs))]
                ests = [a[0] for a in aligned]
                refs = [a[1] for a in aligned]

            def pesq_job(i):
                n = min(len(ests[i]), len(refs[i]))
                return pesq_16k(refs[i][:n], ests[i][:n], fs_ref[i],
                                compute=compute_pesq)

            with ThreadPoolExecutor(max_workers=n_workers) as pool:
                pesq_futs = [pool.submit(pesq_job, i)
                             for i in range(len(pairs))]
                # the fused passes on a worker of their own, overlapping
                # STOI's host stage below
                fused_fut = pool.submit(fused_metrics_packed, ests, refs,
                                        fs_ref[0], device=device)
                stoi_vals = stoi_packed(refs, ests, fs_ref[0], pool=pool,
                                        device=device)
                dev = fused_fut.result()
                pesq_vals = [f.result() for f in pesq_futs]
            S = np.zeros((len(pairs), 6))
            S[:, :4] = dev
            S[:, 4] = pesq_vals
            S[:, 5] = stoi_vals
            scores = list(S)
        else:
            # mixed sample rates: SegSNR's frame differs a file, so the
            # pairs go through the per-file passes
            def job(i):
                xe, xr = _apply_alignment(ests[i], refs[i], fs_ref[i],
                                          align)
                return _score_pair(xe, xr, fs_ref[i],
                                   compute_pesq=compute_pesq, device=device)

            with ThreadPoolExecutor(max_workers=n_workers) as pool:
                scores = list(pool.map(job, range(len(pairs))))
    else:
        def job(pair):
            return compute_scores(pair[0], pair[1],
                                  compute_pesq=compute_pesq, align=align,
                                  device=device)

        # decoding on a small thread pool overlaps the device passes
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            scores = list(pool.map(job, pairs))
    S = np.stack(scores)

    if verbose:
        for label, val in zip(SCORE_LABELS, S.mean(axis=0)):
            print(f"  mean {label}: {val:.3f}")

    if savefile is not None:
        os.makedirs(os.path.dirname(os.path.abspath(savefile)), exist_ok=True)
        np.savez(savefile, S=S, labels=np.array(SCORE_LABELS, dtype="S"),
                 align=np.array(align))
    return S, list(SCORE_LABELS)


def score_dataset(dataset, description, snr_name=None, savefile=None,
                  datadir="", compute_pesq=True, flag_rescore=False,
                  verbose=False, device="cuda"):
    """Score a dataset's enhanced outputs, optionally one SNR bucket.

    As AudioDataset.score_audio (audio_dataset.py:399-435): the enhanced
    paths come from the clean taskfile by the 'scaled' ->
    'enhanced_<desc>' substitution; the SNR filter keeps files whose path
    contains '/<snr>/'.
    """
    y_wavfiles = list(dataset.y_wavfiles)
    if snr_name is None:
        refs = y_wavfiles
    else:
        refs = [w for w in y_wavfiles if f"/{snr_name}/" in w]
    enh = [w.replace("scaled", f"enhanced_{description}") for w in refs]

    if savefile is None:
        tag = description if snr_name is None else f"{description}_{snr_name}"
        savefile = os.path.join(datadir, "scores", f"scores_{tag}.npz")

    return score_taskfiles(
        enh, refs, savefile=savefile, compute_pesq=compute_pesq,
        flag_rescore=flag_rescore, verbose=verbose, device=device)


def aggregate_snr_scores(per_snr_scores, n_wavfiles):
    """Sum raw scores over SNR buckets / total files (enhance.py:1405-1414)."""
    total = None
    for S, _ in per_snr_scores:
        s = np.sum(S, axis=0, keepdims=True)
        total = s if total is None else total + s
    return total / n_wavfiles
