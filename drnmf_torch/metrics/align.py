"""P.862-style time alignment for arbitrary wav pairs (host pre-pass).

The port's own copy of ``drnmf_tpu/metrics/align.py`` (numpy only),
bit-equal to it; ``python -m drnmf_torch.score_audio`` is the general scorer
named below.

What the reference did, stated precisely: its PESQ stage aligned
internally -- score_audio.m:225 calls Loizou's ``pesq_16kHz``, which
implements ITU-T P.862 §8 (envelope-based coarse alignment at 4 ms
granularity, utterance splitting on the reference, per-utterance coarse
+ fine delay) -- while SDR/SNR/SegSNR/STOI were computed on the RAW pair
truncated to the common length (score_audio.m:186-238), so only PESQ was
robust to a shifted estimate there.  This module reimplements the P.862
§8 alignment structure once, host-side, and the scorer applies it to ALL
SIX metrics -- a deliberate extension beyond the reference (a shifted
pair's SNR/SegSNR/STOI are meaningless, and the reference corpus never
shipped shifted pairs): opt-out via ``--no-align`` in
``python -m drnmf_torch.score_audio``, and the in-repo mask pipeline
(sample-aligned by construction) keeps the detection-only guard tier.

This module is the HOST side: cheap O(n log n) numpy estimators that run
before the packed device engine, so every pair -- aligned or not --
rides the bucket-speed path.  ``engine.score_all_packed`` applies the
compensation either by offset-adjusting the already-resident device
buffers (constant delay: no second transfer) or by scoring a
host-reconstructed piecewise-aligned pair through a second packed pass.

Deviations from ITU-T P.862 §8, stated plainly:

- fine alignment is INTEGER-sample; the parabolic sub-sample estimate is
  returned but not compensated (compensating would resample the signal,
  and a <=0.5-sample residual at 16 kHz is far below the six-metric
  engine's sensitivity);
- utterance splitting is an energy VAD on the reference (32 ms frames,
  threshold relative to the active peak), not P.862's speech detector;
- no re-splitting of an utterance on delay jumps WITHIN it (P.862
  §8.4's bad-interval handling) -- each utterance gets one constant
  delay, refined around the global estimate.
"""

from typing import NamedTuple

import numpy as np

COARSE_FRAME = 64  # 4 ms at 16 kHz -- P.862's coarse alignment granularity


class DelayEstimate(NamedTuple):
    d: int        # integer sample delay (positive: est lags ref)
    frac: float   # parabolic sub-sample refinement in [-0.5, 0.5]
    peak: float   # normalized correlation peak (0..1), confidence


def _xcorr_delay(a, b, max_lag=None, around=0):
    """Integer lag d maximizing |linear cross-correlation|
    sum_t a[t] b[t-d] (positive d: ``a`` lags ``b``), searched over the
    full range [-(len(b)-1), len(a)-1], or |d - around| <= max_lag when
    bounded.  Ties break toward ``around``.  Returns
    (d, normalized peak, (c[d-1], c[d], c[d+1]) |correlation| triple)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    na, nb = len(a), len(b)
    n = na + nb - 1
    nfft = 1 << max(4, (n - 1).bit_length())
    fa = np.fft.rfft(a, nfft)
    fb = np.fft.rfft(b, nfft)
    c = np.fft.irfft(fa * np.conj(fb), nfft)
    # c[k] = sum_t a[t] b[t-k]: lag k >= 0 at index k, lag k < 0 at nfft+k
    lags = np.concatenate([np.arange(0, na), np.arange(-(nb - 1), 0)])
    vals = np.abs(np.concatenate([c[:na], c[nfft - (nb - 1):]]))
    score = vals * (1.0 - 1e-9 * np.abs(lags - around) / max(n, 1))
    if max_lag is not None:
        score = np.where(np.abs(lags - around) <= max_lag, score, -1.0)
    k = int(np.argmax(score))
    d = int(lags[k])

    def at(lag):
        if -(nb - 1) <= lag <= na - 1:
            return vals[lag if lag >= 0 else na + (nb - 1) + lag]
        return 0.0

    ea, eb = float(np.dot(a, a)), float(np.dot(b, b))
    peak = float(vals[k]) / max(np.sqrt(ea * eb), 1e-30)
    return d, peak, (at(d - 1), float(vals[k]), at(d + 1))


def estimate_delay(est, ref, fs: int = 16000) -> DelayEstimate:
    """Global delay of ``est`` relative to ``ref``: coarse envelope
    cross-correlation (UNBOUNDED lag at COARSE_FRAME granularity -- the
    round-3 engine's device estimate capped at +-2047 samples; this is
    the P.862 §8.1-style stage that removes that cap), then full-rate
    integer refinement within +-2 coarse frames of the coarse peak."""
    est = np.asarray(est, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    if (min(len(est), len(ref)) < 2 * COARSE_FRAME
            or not est.any() or not ref.any()):
        return DelayEstimate(0, 0.0, 0.0)

    def env(x):
        m = len(x) // COARSE_FRAME * COARSE_FRAME
        return np.abs(x[:m]).reshape(-1, COARSE_FRAME).sum(axis=1)

    dc, _, _ = _xcorr_delay(env(est), env(ref))
    coarse = dc * COARSE_FRAME
    d, peak, (cm, c0, cp) = _xcorr_delay(
        est, ref, max_lag=2 * COARSE_FRAME, around=coarse)
    denom = cm - 2.0 * c0 + cp
    frac = 0.0 if denom >= 0 else float(np.clip(
        0.5 * (cm - cp) / denom, -0.5, 0.5))
    return DelayEstimate(d, frac, peak)


def split_utterances(ref, fs: int = 16000, frame_s: float = 0.032,
                     thresh_db: float = 35.0, min_utt_s: float = 0.3,
                     min_gap_s: float = 0.2):
    """[(start, end)] sample spans of active signal in the reference
    (energy VAD standing in for P.862 §8.2's utterance splitting): 32 ms
    frame energies, active when within ``thresh_db`` of the peak frame,
    gaps under ``min_gap_s`` merged, runs under ``min_utt_s`` dropped.
    Falls back to the whole file when nothing clears the threshold."""
    ref = np.asarray(ref, np.float64).ravel()
    frame = max(1, int(frame_s * fs))
    m = len(ref) // frame
    if m == 0:
        return [(0, len(ref))]
    e = (ref[: m * frame].reshape(m, frame) ** 2).sum(axis=1)
    peak = float(e.max())
    if peak <= 0.0:
        return [(0, len(ref))]
    active = e > peak * 10.0 ** (-thresh_db / 10.0)
    spans = []
    i = 0
    while i < m:
        if active[i]:
            j = i
            while j < m and active[j]:
                j += 1
            spans.append([i, j])
            i = j
        else:
            i += 1
    min_gap = max(1, int(round(min_gap_s * fs / frame)))
    merged = []
    for s in spans:
        if merged and s[0] - merged[-1][1] < min_gap:
            merged[-1][1] = s[1]
        else:
            merged.append(s)
    min_utt = max(1, int(round(min_utt_s * fs / frame)))
    out = [(s0 * frame, min(s1 * frame, len(ref)))
           for s0, s1 in merged if s1 - s0 >= min_utt]
    return out or [(0, len(ref))]


def align_pair(est, ref, fs: int = 16000, margin_s: float = 0.25,
               min_peak: float = 0.05):
    """Per-utterance integer delays of ``est`` vs ``ref`` (P.862 §8.3's
    utterance alignment): one global coarse+fine estimate, then each
    reference utterance re-estimated inside a ``margin_s`` window around
    the globally-shifted span.  Utterances whose correlation peak is
    below ``min_peak`` (near-silence) inherit the global delay.

    Returns (utts, delays, global_estimate)."""
    est = np.asarray(est, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    g = estimate_delay(est, ref, fs)
    utts = split_utterances(ref, fs)
    if len(utts) == 1:
        return utts, [g.d], g
    margin = int(margin_s * fs)
    delays = []
    for s0, s1 in utts:
        e0 = max(0, s0 + g.d - margin)
        e1 = min(len(est), s1 + g.d + margin)
        if e1 - e0 < 4 * COARSE_FRAME:
            delays.append(g.d)
            continue
        du = estimate_delay(est[e0:e1], ref[s0:s1], fs)
        delays.append((e0 - s0) + du.d if du.peak >= min_peak else g.d)
    return utts, delays, g


def compensate_piecewise(est, ref, utts, delays):
    """Host-reconstructed aligned pair for a PIECEWISE delay profile:
    reference-timeline sample t inside utterance u reads
    ``est[t + delays[u]]``; each inter-utterance gap takes the following
    utterance's delay (the trailing gap takes the last one's), so region
    seams land in low-energy gaps.  The pair is finally trimmed to the
    span where the first and last regions' source samples exist, keeping
    edge zero-fill out of the metrics.  Returns (est_aligned, ref_trim),
    float32."""
    est = np.asarray(est, np.float32).ravel()
    ref = np.asarray(ref, np.float32).ravel()
    n = len(ref)
    # region r: [bound[r], bound[r+1]) with delay delays[r]
    bounds = [0] + [s1 for (_, s1) in utts[:-1]] + [n]
    est_al = np.zeros(n, np.float32)
    for r, d in enumerate(delays):
        r0, r1 = bounds[r], bounds[r + 1]
        s0, s1 = max(0, r0 + d), min(len(est), r1 + d)
        if s1 > s0:
            est_al[s0 - d: s1 - d] = est[s0:s1]
    t0 = max(0, -int(delays[0]))
    t1 = n - max(0, n + int(delays[-1]) - len(est))
    return est_al[t0:t1], ref[t0:t1]
