"""The scoring engine: all six metrics and the time alignment of many
pairs on the device (counterpart of ``drnmf_tpu/metrics/engine.py``).

One packed host-to-device transfer a power-of-two bucket feeds one pass
that computes all six metrics (SDR, SNR and SegSNR as in ``fused.py``,
PESQ as ``pesq_device.py``, STOI as ``stoi_device.py``) and an integer
delay estimate, returning one (B, 7) tensor: no host metric math beyond
the wav decode and the packing, one result read a bucket.  PCM16 signals
cross as int16 and are dequantized on the device.

Time alignment (the reference aligned inside its PESQ stage only,
score_audio.m:225 via pesq_16kHz's P.862 §8 machinery; its other metrics
scored the raw truncated pair, score_audio.m:186-238; here the same
alignment protects all six metrics, an extension, see align.py), two
tiers:

- ``align="guard"`` (default; the mask pipeline is sample-aligned by
  construction): the bucket pass's own delay estimate (argmax FFT
  cross-correlation, +-MAX_LAG samples) flags shifted pairs, which are
  re-scored after constant integer-delay compensation.
- ``align="full"`` (the general scorer, ``python -m
  drnmf_torch.score_audio``): the P.862-style host pre-pass (``align.py``:
  unbounded envelope coarse + fine delay, utterance splitting,
  per-utterance delays) aligns every pair, handling delays beyond MAX_LAG
  and piecewise delays.

Either way the compensation runs at bucket speed: constant-delay pairs
re-run the same resident device buffers with shifted unpack offsets (no
second transfer), and piecewise pairs are reconstructed on the host
(``align.compensate_piecewise``) and scored through one more packed pass.
"""

import numpy as np
import torch

from ..device import resolve_device
from .bss_eval import FLEN, RIDGES, _next_pow2, _sdr_padded, bss_eval_sdr
from .fused import _unpack, fused_rows, pack_pair, to_device
from .pesq_device import pesq_rows
from .scoring import SCORE_LABELS  # noqa: F401  (re-export, one source)
from .stoi_device import stoi_rows

MAX_LAG = 2047  # +-128 ms at 16 kHz (the guard tier; "full" is unbounded)


def _delay_rows(est_rows, ref_rows, lengths):
    """(B,) integer delay of est relative to ref (positive: est lags), from
    the circular FFT cross-correlation.  Rows are zero-padded to the FFT
    length, so lags within the per-row padding are linear correlations;
    lags beyond it are masked out."""
    nfft = est_rows.shape[-1]
    device = est_rows.device
    # short buckets (nfft < 2*MAX_LAG+1) can't represent the full lag range
    max_lag = min(MAX_LAG, nfft // 2 - 1)
    c = torch.fft.irfft(torch.fft.rfft(est_rows)
                        * torch.fft.rfft(ref_rows).conj(), n=nfft)
    lags = torch.cat([torch.arange(0, max_lag + 1, device=device),
                      torch.arange(-max_lag, 0, device=device)])
    vals = torch.cat([c[:, : max_lag + 1], c[:, nfft - max_lag:]],
                     dim=-1).abs()
    # tie-break toward zero delay; mask lags that would wrap into the
    # signal; argmax takes the first of equal maxima
    vals = vals * (1.0 - 1e-6 * lags.abs()[None, :] / (max_lag + 1))
    ok = lags.abs()[None, :] <= torch.clamp(nfft - lengths[:, None] - 1,
                                            min=0)
    vals = torch.where(ok, vals, -1.0)
    return lags[torch.argmax(vals, dim=-1)]


def _dequant(c):
    """int16 packed buffer -> float32 on the device (x / 32768, the scale
    of the float wav reader): PCM16 crosses at half the bytes."""
    if c.dtype == torch.int16:
        return c.to(torch.float32) * (1.0 / 32768.0)
    return c


def _rows(w):
    """A bucket's zero-padded (B, nfft) estimate and reference rows and
    its lengths, from the resident packed buffers."""
    est_c, ref_c, est_off, ref_off, lengths = w[2]
    return (_unpack(_dequant(est_c), est_off, lengths, w[0]),
            _unpack(_dequant(ref_c), ref_off, lengths, w[0]), lengths)


def _fused_packed_any(w, ridge, flen, frame_len):
    """A retry round: only the fused family (SDR/SNR/SegSNR) depends on
    the ridge, so the PESQ/STOI/delay work of the first pass is not
    redone."""
    return fused_rows(*_rows(w), ridge, flen, frame_len)


def _engine_bucket(w, ridge, flen, frame_len, fs, compute_pesq):
    """All metrics and the delay of one bucket as one (B, 7) tensor
    [SDR, SNR, SegSNR local, SegSNR global, PESQ, STOI, delay]."""
    se, s, lengths = _rows(w)
    fused = fused_rows(se, s, lengths, ridge, flen, frame_len)
    delay = _delay_rows(se, s, lengths)
    pesq = (pesq_rows(s, se, lengths, fs=fs) if compute_pesq
            else torch.full((se.shape[0],), -1.0, device=se.device))
    sto = stoi_rows(s, se, lengths, fs=fs)
    return torch.cat([fused, torch.stack([pesq, sto, delay.to(se.dtype)],
                                         dim=1)], dim=1)


def _as_f32(x, n):
    """Host-side row normalization: slice to ``n`` samples and apply the
    same int16 dequant rule the device pass uses (x / 32768); float
    entries pass through as float32."""
    arr = np.asarray(x[:n])
    if arr.dtype == np.int16:
        return arr.astype(np.float32) * np.float32(1.0 / 32768.0)
    return np.asarray(arr, np.float32)


def _score_pass(work, S, delays, flen, frame_len, fs, compute_pesq,
                slice_fn, commit_delay, device):
    """One engine pass over ``work`` (bucket items ``[nfft, idxs, (est_c,
    ref_c, est_off, ref_off, lengths), pending mask, result cache, host
    offsets]``): the six-metric pass at the first ridge, then the retry
    rounds of the ridge (1e-5, 1e-3) on the fused family only, then the
    exact per-file SDR fallback (``slice_fn(i)`` gives the possibly
    shifted host signals).  Commits finished rows into ``S`` (and
    ``delays`` when ``commit_delay``) and clears them from each item's
    pending mask.  Every bucket of a round is queued before any result is
    read, and each is read with one copy to the host."""
    def commit(w, vals, rows):
        S[w[1][rows]] = vals[rows, :6]
        if commit_delay:
            delays[w[1][rows]] = np.round(vals[rows, 6]).astype(np.int64)

    first = [(w, _engine_bucket(w, RIDGES[0], flen, frame_len, fs,
                                compute_pesq)) for w in work]
    for w, res in first:
        w[4] = res.cpu().numpy()  # (B, 7), kept for the retry merges
        newly = w[3] & np.isfinite(w[4][:, 0])
        commit(w, w[4], newly)
        w[3] = w[3] & ~newly

    for ridge in RIDGES[1:]:
        pending = [(w, _fused_packed_any(w, ridge, flen, frame_len))
                   for w in work if w[3].any()]
        for w, res in pending:
            vals = w[4]
            vals[:, :4] = res.cpu().numpy()
            need = w[3]
            newly = need & np.isfinite(vals[:, 0])
            commit(w, vals, newly)
            need &= ~newly
            if need.any() and ridge == RIDGES[-1]:
                commit(w, vals, need)
                for i in w[1][need]:
                    est_i, ref_i = slice_fn(int(i))
                    S[i, 0] = bss_eval_sdr(est_i, ref_i, flen=flen,
                                           device=device)
                need &= False


def sdr_at_ridges(est_list, ref_list, flen: int = FLEN, device="cuda"):
    """(n_files, len(RIDGES)) SDR of each pair at each ridge of the
    escalation (NaN where the factorization fails): the engine keeps the
    first finite one.  Shows which rows escalated, and lets two devices
    be compared at equal ridges where float32 roundoff rescues a
    borderline row at another ridge on each."""
    device = resolve_device(device)
    out = np.zeros((len(est_list), len(RIDGES)))
    lens = np.array([min(len(e), len(r)) for e, r in zip(est_list, ref_list)])
    buckets = {}
    for i, n in enumerate(lens):
        buckets.setdefault(_next_pow2(n + flen), []).append(i)
    for nfft, idxs in sorted(buckets.items()):
        est_c, ref_c, offsets = pack_pair(est_list, ref_list, idxs, lens,
                                          convert=_as_f32)
        off = to_device(offsets, device)
        w = [nfft, None, (to_device(est_c, device), to_device(ref_c, device),
                          off, off, to_device(lens[idxs], device))]
        se, s, n_t = _rows(w)
        for k, ridge in enumerate(RIDGES):
            out[idxs, k] = _sdr_padded(se, s, n_t, flen=flen,
                                       ridge=ridge).cpu().numpy()
    return out


def score_all_packed(est_list, ref_list, fs: int = 16000,
                     compute_pesq: bool = True, flen: int = FLEN,
                     tf: float = 0.01, verbose: bool = False,
                     align: str = "guard", device="cuda"):
    """(n_files, 6) [SDR, SNR, SegSNR local, SegSNR global, PESQ, STOI] and
    (n_files,) estimated integer delays, computed on ``device`` a
    power-of-two bucket at a time with one packed transfer a bucket.

    ``align``: "guard" compensates constant delays the bucket pass's
    +-MAX_LAG estimate detects; "full" runs the P.862-style host alignment
    (unbounded + per-utterance, ``align.py``) on every pair; "off" scores
    the pairs as given (used for the re-passes).  The returned delay of a
    compensated pair is the constant delay applied (piecewise pairs report
    their global estimate).

    Entries may be float32 or raw PCM16 int16 (``native_loader
    .read_batch_i16``): where every entry is int16 the buffers cross as
    int16 and are dequantized on the device (x / 32768), half the bytes
    and the same values; a mixed list is packed as float32 with its int16
    entries dequantized on the host."""
    if align not in ("guard", "full", "off"):
        raise ValueError(f"align must be guard/full/off, got {align!r}")
    device = resolve_device(device)
    n_files = len(est_list)
    S = np.zeros((n_files, 6), np.float64)
    delays = np.zeros(n_files, np.int64)
    frame_len = int(round(tf * fs))
    lens = np.zeros(n_files, np.int64)
    buckets = {}
    for i, (se, s) in enumerate(zip(est_list, ref_list)):
        lens[i] = min(len(se), len(s))
        buckets.setdefault(_next_pow2(lens[i] + flen), []).append(i)

    is_i16 = all(np.asarray(x).dtype == np.int16 for x in est_list) and all(
        np.asarray(x).dtype == np.int16 for x in ref_list)
    pack_dtype = np.int16 if is_i16 else np.float32

    work = []
    for nfft, idxs in sorted(buckets.items()):
        est_c, ref_c, offsets = pack_pair(
            est_list, ref_list, idxs, lens, pack_dtype,
            convert=None if is_i16 else _as_f32)
        off = to_device(offsets, device)
        args = (to_device(est_c, device), to_device(ref_c, device), off, off,
                to_device(lens[idxs], device))
        work.append([nfft, np.asarray(idxs), args,
                     np.ones(len(idxs), bool), None, offsets])

    _score_pass(work, S, delays, flen, frame_len, fs, compute_pesq,
                slice_fn=lambda i: (_as_f32(est_list[i], lens[i]),
                                    _as_f32(ref_list[i], lens[i])),
                commit_delay=True, device=device)
    if align == "off":
        return S, delays

    # alignment: a compensation plan for each pair
    const_d = {}   # i -> constant integer delay to compensate
    piecewise = {}  # i -> (utts, per-utterance delays)
    if align == "full":
        from .align import align_pair

        for i in range(n_files):
            n = int(lens[i])
            utts, uds, g = align_pair(_as_f32(est_list[i], n),
                                      _as_f32(ref_list[i], n), fs)
            delays[i] = int(g.d)
            if all(d == 0 for d in uds):
                delays[i] = 0
            elif len(set(uds)) == 1:
                const_d[i] = int(uds[0])
                delays[i] = int(uds[0])
            else:
                piecewise[i] = (utts, uds)
    else:
        # guard tier: the bucket pass's +-MAX_LAG estimate detects the
        # shift; the unbounded host estimator refines it (the bounded
        # full-rate cross-correlation of a periodic carrier can alias to a
        # pitch-period lag; the envelope coarse stage disambiguates).
        # Aligned pairs never reach this loop.
        from .align import estimate_delay

        for i in np.nonzero(delays != 0)[0]:
            n = int(lens[i])
            de = estimate_delay(_as_f32(est_list[i], n),
                                _as_f32(ref_list[i], n), fs)
            delays[i] = int(de.d)
            if de.d != 0:
                const_d[int(i)] = int(de.d)

    min_keep = max(flen, frame_len)
    for i in [k for k, d in const_d.items()
              if lens[k] - abs(d) < min_keep]:
        # a delay this large against the file is a spurious correlation
        # peak, not a misalignment: compensating would score a
        # (near-)empty slice; keep the unshifted scores
        print(f"  WARNING: estimated delay of {const_d[i]} samples for "
              f"pair {i} leaves <{min_keep} overlapping samples; treating "
              f"the estimate as spurious and keeping unshifted scores")
        delays[i] = 0
        del const_d[i]

    # constant delays: the same resident buffers with shifted unpack
    # offsets (the estimate's rows start d samples later for d > 0, the
    # reference's for d < 0, both cut to the overlap)
    if const_d:
        for i, d in sorted(const_d.items()):
            print(f"  WARNING: estimated delay of {d} samples between "
                  f"estimate and reference for pair {i}; re-scoring after "
                  f"compensation")
        work2 = []
        for w in work:
            hit = np.isin(w[1], list(const_d))
            if not hit.any():
                continue
            est_c, ref_c = w[2][:2]
            eoff, roff = w[5].copy(), w[5].copy()
            blens = lens[w[1]].copy()
            for row in np.nonzero(hit)[0]:
                d = const_d[int(w[1][row])]
                eoff[row] += max(d, 0)
                roff[row] += max(-d, 0)
                blens[row] -= abs(d)
            args2 = (est_c, ref_c, to_device(eoff, device),
                     to_device(roff, device), to_device(blens, device))
            work2.append([w[0], w[1], args2, hit, None, None])

        def slice_shifted(i):
            d = const_d.get(i, 0)
            n = int(lens[i])
            est_i = _as_f32(est_list[i], n)
            ref_i = _as_f32(ref_list[i], n)
            if d > 0:
                return est_i[d:], ref_i[: n - d]
            if d < 0:
                return est_i[: n + d], ref_i[-d:]
            return est_i, ref_i

        _score_pass(work2, S, delays, flen, frame_len, fs, compute_pesq,
                    slice_fn=slice_shifted, commit_delay=False,
                    device=device)

    # piecewise delays (align="full" only): the aligned estimate rebuilt
    # on the host (seams in inter-utterance gaps), scored in one more pass
    if piecewise:
        from .align import compensate_piecewise

        idxs, e2, r2 = [], [], []
        for i, (utts, uds) in sorted(piecewise.items()):
            print(f"  WARNING: piecewise delays {uds} (utterances "
                  f"{utts}) for pair {i}; re-scoring after per-utterance "
                  f"compensation")
            ea, ra = compensate_piecewise(
                _as_f32(est_list[i], lens[i]), _as_f32(ref_list[i], lens[i]),
                utts, uds)
            if len(ra) < min_keep:
                print(f"  WARNING: compensated overlap for pair {i} too "
                      f"short; keeping unshifted scores")
                delays[i] = 0
                continue
            idxs.append(i)
            e2.append(ea)
            r2.append(ra)
        if idxs:
            S2, _ = score_all_packed(e2, r2, fs, compute_pesq=compute_pesq,
                                     flen=flen, tf=tf, align="off",
                                     device=device)
            S[np.asarray(idxs)] = S2

    n_comp = len(const_d) + len(piecewise)
    if verbose and n_comp:
        print(f"  {n_comp} pair(s) required delay compensation")
    return S, delays
