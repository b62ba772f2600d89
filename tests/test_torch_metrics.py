"""The port's scoring metrics (drnmf_torch.metrics) against the JAX
package's (drnmf_tpu.metrics) on the CPU, on the same numpy inputs.

Tolerances: the numpy modules the port copies (the PESQ model, the
alignment, ``pack_pair``, ``snr``, STOI's host stage) bit-equal; SDR, SNR
and segmental SNR within 1e-3 dB of the JAX package's on broadband and
corpus-like PCM16 references (float32 on both sides, FFTs and the
Cholesky solve in other libraries), and both within 0.05 dB of the
float64 oracle of ``tests/test_metrics.py::ref_sdr_f64``; PESQ within
2e-3 MOS and STOI within 1e-3 (the JAX package's own device-against-host
tolerances, tests/test_metrics.py:370-396); the resampler within 2e-6 of
scipy; delays equal.  Near-periodic references (a few AM sinusoids) make
the 512-tap Toeplitz system rank-deficient in float32 in both packages,
and which ridge rescues a row there depends on the roundoff of the FFTs:
their SDR is held to be finite and to have escalated, not to equal the
JAX package's.  Signals are at most 1.5 s and 8 pairs a case.
"""

import importlib

import numpy as np
import pytest
import scipy.linalg
import scipy.signal
import torch

from drnmf_torch.data import synthetic as tsynth
from drnmf_torch.metrics import bss_eval as tbss
from drnmf_torch.metrics import engine as teng
from drnmf_torch.metrics import fused as tfused
from drnmf_torch.metrics import pesq_device as tpesq
from drnmf_torch.metrics import stoi_device as tstoi_dev

jbss = importlib.import_module("drnmf_tpu.metrics.bss_eval")
jeng = importlib.import_module("drnmf_tpu.metrics.engine")
jfused = importlib.import_module("drnmf_tpu.metrics.fused")
jpesq = importlib.import_module("drnmf_tpu.metrics.pesq_device")
jsnr = importlib.import_module("drnmf_tpu.metrics.snr")
jstoi = importlib.import_module("drnmf_tpu.metrics.stoi")
jstoi_dev = importlib.import_module("drnmf_tpu.metrics.stoi_device")
jalign = importlib.import_module("drnmf_tpu.metrics.align")
jmodel = importlib.import_module("drnmf_tpu.metrics._pesq_model")
tstoi = importlib.import_module("drnmf_torch.metrics.stoi")
talign = importlib.import_module("drnmf_torch.metrics.align")
tmodel = importlib.import_module("drnmf_torch.metrics._pesq_model")
tsnr = importlib.import_module("drnmf_torch.metrics.snr")

FS = 16000
DB_TOL = 1e-3
PESQ_TOL = 2e-3
STOI_TOL = 1e-3
ORACLE_TOL = 0.05
CPU = "cpu"


def ref_sdr_f64(se, s, flen=512):
    """float64 numpy transcription of bss_eval_sources' single-source
    projection (``tests/test_metrics.py::ref_sdr_f64``)."""
    n = len(se)
    nfft = 1 << (n + flen - 1).bit_length()
    sf = np.fft.rfft(s, nfft)
    sef = np.fft.rfft(se, nfft)
    r = np.fft.irfft(sf * np.conj(sf), nfft)[:flen]
    c = np.fft.irfft(sef * np.conj(sf), nfft)[:flen]
    R = scipy.linalg.toeplitz(r)
    h = np.linalg.solve(R + 1e-12 * r[0] * np.eye(flen), c)
    s_target = np.fft.irfft(np.fft.rfft(h, nfft) * sf, nfft)[: n + flen - 1]
    e = np.concatenate([se, np.zeros(flen - 1)]) - s_target
    return 10 * np.log10(np.sum(s_target**2) / np.sum(e**2))


def _pcm16(x):
    return np.clip(np.round(np.asarray(x) * 32768.0), -32768,
                   32767).astype(np.int16)


def _dequant(x):
    return x.astype(np.float32) / np.float32(32768.0)


def _corpus_pairs(rng, lengths, snrs_db=(-6, 0, 3, 9)):
    """make_synthetic_corpus-shaped pairs (its harmonic stack with vibrato
    and its shaped noise), PCM16: (est, ref) float32 lists."""
    ests, refs = [], []
    for k, n in enumerate(lengths):
        clean = tsynth._synthetic_speech(rng, n, FS)
        noise = tsynth._synthetic_noise(rng, n, FS)
        snr_db = snrs_db[k % len(snrs_db)]
        noise *= np.sqrt(np.mean(clean**2)
                         / (np.mean(noise**2) * 10 ** (snr_db / 10)))
        refs.append(_dequant(_pcm16(clean)))
        ests.append(_dequant(_pcm16(clean + 0.5 * noise)))
    return ests, refs


def _broadband_pairs(rng, lengths, amp=0.05):
    refs = [_dequant(_pcm16(0.1 * rng.standard_normal(n))) for n in lengths]
    ests = [_dequant(_pcm16(r + amp * rng.standard_normal(len(r))))
            for r in refs]
    return ests, refs


def _am_sines(rng, lengths):
    """bench.py::bench_score's near-periodic pairs: a sinusoid at 2 Hz AM
    plus white noise, PCM16."""
    ests, refs = [], []
    for i, n in enumerate(lengths):
        t = np.arange(n) / FS
        ref = (0.1 * np.sin(2 * np.pi * (120 + 40 * (i % 5)) * t)
               * (0.5 + 0.5 * np.sin(2 * np.pi * 2.0 * t)))
        refs.append(_pcm16(ref))
        ests.append(_pcm16(ref + 0.02 * rng.standard_normal(n)))
    return ests, refs


def _gappy(rng, utt=6000, gap=4000, n_utts=2):
    """Corpus-like bursts between silences (utterance structure for the
    alignment)."""
    parts = [np.zeros(gap, np.float32)]
    for _ in range(n_utts):
        parts += [tsynth._synthetic_speech(rng, utt, FS),
                  np.zeros(gap, np.float32)]
    return np.concatenate(parts)


def _shift(x, d):
    if d >= 0:
        return np.concatenate([np.zeros(d, x.dtype), x[: len(x) - d]])
    return np.concatenate([x[-d:], np.zeros(-d, x.dtype)])


def _noisy_active(rng, ref, amp=0.02):
    mask = (np.abs(ref) > 0).astype(np.float32)
    return ref + amp * mask * rng.standard_normal(len(ref)).astype(np.float32)


def _sdr_by_ridge(est, ref):
    """The SDR of one pair at each ridge: (port's, JAX's)."""
    est, ref = teng._as_f32(est, len(est)), teng._as_f32(ref, len(ref))
    n = min(len(est), len(ref))
    nfft = tbss._next_pow2(n + tbss.FLEN)
    se, s = (np.pad(x[:n], (0, nfft - n)) for x in (est, ref))
    port = list(teng.sdr_at_ridges([est], [ref], device=CPU)[0])
    jax_ = [float(jbss._sdr_padded(se, s, n, ridge=ridge))
            for ridge in tbss.RIDGES]
    return port, jax_


def _assert_columns(got, want, rows, what, pairs=None, sdr=True):
    """Each column of (n, 6) score rows at its tolerance.  An SDR further
    apart is accepted only where the two packages kept different ridges
    (the first ridge rescues the row on one side and not on the other, a
    float32 borderline): then each side's SDR at each ridge must agree
    within the tolerance wherever both are finite (``pairs``: the rows'
    (est, ref) as scored)."""
    tols = [DB_TOL] * 4 + [PESQ_TOL, STOI_TOL]
    for col, tol in enumerate(tols):
        if col == 0:
            if not sdr:
                continue
            for i in rows:
                if got[i, 0] == want[i, 0] or abs(got[i, 0]
                                                  - want[i, 0]) <= tol:
                    continue
                port, jax_ = _sdr_by_ridge(*pairs[i])
                first = [next(k for k, v in enumerate(side) if np.isfinite(v))
                         for side in (port, jax_)]
                assert first[0] != first[1], (what, i, port, jax_)
                assert got[i, 0] == pytest.approx(port[first[0]], abs=tol)
                assert want[i, 0] == pytest.approx(jax_[first[1]], abs=tol)
                for a, b in zip(port, jax_):
                    assert not (np.isfinite(a) and np.isfinite(b)) \
                        or abs(a - b) <= tol, (what, i, port, jax_)
            continue
        np.testing.assert_allclose(got[rows, col], want[rows, col], rtol=0,
                                   atol=tol, err_msg=f"{what} column {col}")


def test_numpy_copies_bit_equal(rng):
    """The modules the port copies give the JAX package's bits: the PESQ
    model (its tables and constants too), the alignment, pack_pair, snr,
    STOI's host stage and the resampler's design."""
    ests, refs = _corpus_pairs(rng, (9000, 14000, 20000))
    for name in dir(jmodel):
        val = getattr(jmodel, name)
        if isinstance(val, (np.ndarray, float, int)):
            np.testing.assert_array_equal(getattr(tmodel, name), val,
                                          err_msg=name)
    for est, ref in zip(ests, refs):
        for fs in (16000, 8000):
            a = tmodel.pesq_mos_aligned(np.float64(ref), np.float64(est), fs)
            b = jmodel.pesq_mos_aligned(np.float64(ref), np.float64(est), fs)
            assert a == b or (np.isnan(a) and np.isnan(b)), (fs, a, b)
        assert tsnr.snr(est, ref) == jsnr.snr(est, ref)
        for got, want in zip(tstoi._host_stage(ref, est, FS),
                             jstoi._host_stage(ref, est, FS)):
            np.testing.assert_array_equal(got, want)

    ref = _gappy(rng)
    est = _noisy_active(rng, ref)
    assert talign.split_utterances(ref, FS) == \
        jalign.split_utterances(ref, FS)
    for d in (0, 160, -300, 5000):
        assert talign.estimate_delay(_shift(est, d), ref, FS) == \
            jalign.estimate_delay(_shift(est, d), ref, FS), d
    utts = talign.split_utterances(ref, FS)
    es = np.zeros_like(est)
    for (s0, s1), d in zip(utts, (100, 400)):
        lo, hi = s0 + d, min(len(es), s1 + d)
        es[lo:hi] = est[s0: s0 + (hi - lo)]
    got, want = talign.align_pair(es, ref, FS), jalign.align_pair(es, ref, FS)
    assert got == want and got[1] == [100, 400]
    for a, b in zip(talign.compensate_piecewise(es, ref, *got[:2]),
                    jalign.compensate_piecewise(es, ref, *want[:2])):
        np.testing.assert_array_equal(a, b)

    i16 = [_pcm16(x) for x in ests]
    lens = np.array([len(x) - 7 for x in ests])
    for args, convert in (((ests, refs, [2, 0], lens), ()),
                          ((i16, i16, [0, 1, 2], lens, np.int16), ()),
                          ((i16, ests, [1, 2], lens, np.float32),
                           (teng._as_f32, jeng._as_f32))):
        for a, b in zip(tfused.pack_pair(*args, *convert[:1]),
                        jfused.pack_pair(*args, *convert[1:])):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tstoi_dev._design_resampler(5, 8),
                    jstoi_dev._design_resampler(5, 8)):
        np.testing.assert_array_equal(a, b)


def test_sdr_snr_segsnr_match_jax(rng):
    """SDR, SNR and segmental SNR, one pair at a time and batched, within
    1e-3 dB of the JAX package's on corpus-like and broadband PCM16
    references; the SDR of both within 0.05 dB of the float64 oracle."""
    ce, cr = _corpus_pairs(rng, (8000, 12000, 17000, 23000))
    be, br = _broadband_pairs(rng, (6000, 15000))
    ests, refs = ce + be, cr + br
    for i, (est, ref) in enumerate(zip(ests, refs)):
        got = tbss.bss_eval_sdr(est, ref, device=CPU)
        want = jbss.bss_eval_sdr(est, ref)
        oracle = ref_sdr_f64(np.float64(est), np.float64(ref))
        assert abs(got - want) <= DB_TOL, (i, got, want)
        assert abs(got - oracle) <= ORACLE_TOL, (i, got, oracle)
        assert abs(want - oracle) <= ORACLE_TOL, (i, want, oracle)
        np.testing.assert_allclose(tsnr.snrseg(est, ref, device=CPU),
                                   jsnr.snrseg(est, ref), rtol=0,
                                   atol=DB_TOL, err_msg=str(i))
        np.testing.assert_allclose(
            tfused.fused_device_metrics(est, ref, device=CPU),
            jfused.fused_device_metrics(est, ref), rtol=0, atol=DB_TOL,
            err_msg=str(i))
    np.testing.assert_allclose(
        tfused.fused_metrics_packed(ests, refs, device=CPU),
        jfused.fused_metrics_packed(ests, refs), rtol=0, atol=DB_TOL)
    np.testing.assert_allclose(
        tbss.bss_eval_sdr_many(ests, refs, device=CPU),
        jbss.bss_eval_sdr_many(ests, refs), rtol=0, atol=DB_TOL)
    # the padded batch of segmental SNR (frames past a row's length out)
    total = 24000
    pad = np.stack([np.pad(x, (0, total - len(x))) for x in ests])
    padr = np.stack([np.pad(x, (0, total - len(x))) for x in refs])
    lens = [len(x) for x in ests]
    for got, want in zip(tsnr.snrseg_batch(pad, padr, lens, device=CPU),
                         jsnr.snrseg_batch(pad, padr, lens)):
        np.testing.assert_allclose(got, want, rtol=0, atol=DB_TOL)


def test_pesq_stoi_and_resampler_match_jax(rng):
    """PESQ and STOI, batched on the device and one file at a time,
    against the JAX package's and the host models; the polyphase
    resampler against scipy's resample_poly; too short a pair scores NaN
    on both sides."""
    ce, cr = _corpus_pairs(rng, (9000, 16000, 23000))
    be, br = _broadband_pairs(rng, (12000,))
    ests, refs = ce + be, cr + br
    got = tpesq.pesq_packed(refs, ests, device=CPU)
    np.testing.assert_allclose(got, jpesq.pesq_packed(refs, ests), rtol=0,
                               atol=PESQ_TOL)
    for i in range(len(ests)):
        host = tmodel.pesq_mos_aligned(np.float64(refs[i]),
                                       np.float64(ests[i]))
        assert abs(got[i] - host) <= PESQ_TOL, (i, got[i], host)
    short = rng.standard_normal(600).astype(np.float32)
    assert np.isnan(tpesq.pesq_packed([short], [short], device=CPU)[0])

    got = tstoi_dev.stoi_packed_device(refs, ests, device=CPU)
    np.testing.assert_allclose(got, jstoi_dev.stoi_packed_device(refs, ests),
                               rtol=0, atol=STOI_TOL)
    np.testing.assert_allclose(tstoi.stoi_packed(refs, ests, device=CPU),
                               jstoi.stoi_packed(refs, ests), rtol=0,
                               atol=STOI_TOL)
    for i in range(len(ests)):
        per_file = tstoi.stoi(refs[i], ests[i], device=CPU)
        assert abs(per_file - jstoi.stoi(refs[i], ests[i])) <= STOI_TOL, i
        assert abs(got[i] - per_file) <= STOI_TOL, (i, got[i], per_file)
    assert np.isnan(tstoi_dev.stoi_packed_device([short], [short],
                                                 device=CPU)[0])
    assert np.isnan(tstoi.stoi(short, short, device=CPU))

    lens = [1000, 4321, 8000, 8192]
    rows = np.zeros((len(lens), 8192), np.float32)
    for i, n in enumerate(lens):
        rows[i, :n] = rng.standard_normal(n)
    res, n10 = tstoi_dev.resample_rows_16k_to_10k(torch.from_numpy(rows),
                                                  torch.tensor(lens))
    for i, n in enumerate(lens):
        want = scipy.signal.resample_poly(np.float64(rows[i, :n]), 5, 8)
        assert int(n10[i]) == len(want)
        np.testing.assert_allclose(res[i, :len(want)].numpy(), want,
                                   rtol=0, atol=2e-6, err_msg=str(n))
        assert not res[i, len(want):].any()


def test_engine_matches_jax(rng, monkeypatch):
    """score_all_packed against the JAX package's on one battery: int16,
    float and mixed-dtype lists of corpus-like and broadband pairs, a
    short-file bucket, a silent reference (non-finite SDR at every ridge:
    the per-file fallback), near-periodic references (their SDR finite and
    escalated), a constant delay under "guard" (compensated on the
    resident buffers), a spurious delay (kept unshifted) and piecewise
    delays under "full".  Delays equal; every column at its tolerance."""
    ce, cr = _corpus_pairs(rng, (400, 700, 9000, 17000, 23000))
    be, br = _broadband_pairs(rng, (12000,))
    ae, ar = _am_sines(rng, (11000, 20000))
    f_ests, f_refs = ce + be, cr + br
    i_ests, i_refs = [_pcm16(x) for x in f_ests], [_pcm16(x) for x in f_refs]
    silent = np.zeros(5000, np.float32)
    noise = _dequant(_pcm16(0.1 * rng.standard_normal(5000)))

    cases = {
        "int16": (i_ests + ae, i_refs + ar, "guard"),
        "float": (f_ests + [_dequant(x) for x in ae],
                  f_refs + [_dequant(x) for x in ar], "guard"),
        "mixed": ([x if k % 2 else _pcm16(x) for k, x in enumerate(f_ests)],
                  [_pcm16(x) if k % 2 else x for k, x in enumerate(f_refs)],
                  "guard"),
        "silent": ([noise, f_ests[3]], [silent, f_refs[3]], "guard"),
    }
    n_regular = len(f_ests)
    results = {}
    for name, (ests, refs, align) in cases.items():
        got, gd = teng.score_all_packed(ests, refs, align=align, device=CPU)
        want, wd = jeng.score_all_packed(ests, refs, align=align)
        np.testing.assert_array_equal(gd, wd, err_msg=name)
        assert not np.isnan(got[:, :4]).any() or name == "silent", name
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        rows = np.arange(min(len(ests), n_regular))
        _assert_columns(got, want, rows, name, list(zip(ests, refs)))
        results[name] = got, want
    # int16 crosses as int16 and is dequantized on the device: the same
    # values as the float path
    np.testing.assert_allclose(results["int16"][0], results["float"][0],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(results["mixed"][0],
                               results["float"][0][:n_regular], rtol=0,
                               atol=1e-5)
    # the silent reference: -inf SDR and SNR at every ridge, on both sides
    assert np.all(np.isneginf(results["silent"][0][0, :2]))
    # near-periodic references: the first ridge fails, a later one gives a
    # finite SDR; their other columns held
    sines = np.arange(n_regular, n_regular + len(ae))
    got, want = results["int16"]
    assert np.isfinite(got[sines, 0]).all()
    _assert_columns(got, want, sines, "near-periodic", sdr=False)
    for k, (e, r) in enumerate(zip(ae, ar)):
        n = len(r)
        nfft = tbss._next_pow2(n + tbss.FLEN)
        rows = (torch.from_numpy(np.pad(_dequant(x), (0, nfft - n)))[None]
                for x in (e, r))
        first = tbss._sdr_padded(*rows, torch.tensor([n]))
        assert torch.isnan(first).all(), k

    # delays: a constant one under "guard" on white noise (re-scored on
    # the resident buffers, no second packing), a spurious one,
    # piecewise ones and one beyond MAX_LAG under "full"
    ref = (0.1 * rng.standard_normal(14000)).astype(np.float32)
    est = ref + 0.02 * rng.standard_normal(14000).astype(np.float32)
    # a burst that a shift of 750 leaves 450 < 512 samples of overlap:
    # found by both estimators, then refused as spurious
    short = np.zeros(1200, np.float32)
    short[:400] = rng.standard_normal(400)
    assert talign.estimate_delay(np.roll(short, 750), short, FS).d == 750
    gap_ref = _gappy(rng)
    gap_est = _noisy_active(rng, gap_ref)
    utts = talign.split_utterances(gap_ref, FS)
    piecewise = np.zeros_like(gap_est)
    for (s0, s1), d in zip(utts, (300, 900)):
        lo, hi = s0 + d, min(len(piecewise), s1 + d)
        piecewise[lo:hi] = gap_est[s0: s0 + (hi - lo)]
    packs = []
    real_pack = teng.pack_pair
    for align, ests, refs, delays in (
            ("guard", [_shift(est, 800), est, np.roll(short, 750)],
             [ref, ref, short], [800, 0, 0]),
            ("full", [piecewise, _shift(gap_est, 2500)], [gap_ref, gap_ref],
             [None, 2500])):
        monkeypatch.setattr(teng, "pack_pair", lambda *a, **k: (
            packs.append(align), real_pack(*a, **k))[1])
        got, gd = teng.score_all_packed(ests, refs, align=align, device=CPU)
        monkeypatch.undo()
        want, wd = jeng.score_all_packed(ests, refs, align=align)
        np.testing.assert_array_equal(gd, wd, err_msg=align)
        for k, d in enumerate(delays):
            assert d is None or gd[k] == d, (align, k, gd)
        _assert_columns(got, want, np.arange(len(ests)), align,
                        list(zip(ests, refs)))
        if align == "guard":
            n_buckets = len({tbss._next_pow2(len(r) + 512) for r in refs})
            # the re-pass did not repack
            assert packs.count("guard") == n_buckets
            aligned, _ = teng.score_all_packed([est], [ref], align="off",
                                               device=CPU)
            np.testing.assert_allclose(got[0], aligned[0], rtol=0.05,
                                       atol=0.25)


def test_failed_cholesky_is_nan_and_escalates():
    """A factorization that fails (``info > 0``) reads as NaN, where
    ``cholesky_solve`` on the partial factor would give a finite, wrong
    SDR; the NaN sends the pair on to a larger ridge, in bss_eval_sdr and
    in the batched passes, and the value kept is that of the first ridge
    whose SDR is finite."""
    n = 11000
    t = np.arange(n) / FS
    sine = (0.1 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    est = sine + 0.05 * np.random.default_rng(3).standard_normal(n).astype(
        np.float32)
    nfft = tbss._next_pow2(n + tbss.FLEN)
    se, s = (torch.from_numpy(np.pad(x, (0, nfft - n)))[None]
             for x in (est, sine))
    lens = torch.tensor([n])
    first = tbss._sdr_padded(se, s, lens, ridge=tbss.RIDGES[0])
    assert torch.isnan(first).all()
    # the trap: the failed factor, solved anyway, gives a finite number
    r = torch.fft.irfft(torch.fft.rfft(s) * torch.fft.rfft(s).conj(),
                        n=nfft)[0, :tbss.FLEN]
    idx = (torch.arange(tbss.FLEN)[:, None]
           - torch.arange(tbss.FLEN)[None, :]).abs()
    R = r[idx] + (tbss.RIDGES[0] * r[0] + 1e-30) * torch.eye(tbss.FLEN)
    chol, info = torch.linalg.cholesky_ex(R)
    assert int(info) > 0
    assert torch.isfinite(torch.cholesky_solve(torch.ones(tbss.FLEN, 1),
                                               chol)).all()

    by_ridge = [float(tbss._sdr_padded(se, s, lens, ridge=ridge)[0])
                for ridge in tbss.RIDGES]
    kept = next(v for v in by_ridge if np.isfinite(v))
    assert tbss.bss_eval_sdr(est, sine, device=CPU) == pytest.approx(
        kept, abs=1e-6)
    assert np.isfinite(jbss.bss_eval_sdr(est, sine))
    packed = tfused.fused_metrics_packed([est], [sine], device=CPU)
    assert packed[0, 0] == pytest.approx(kept, abs=1e-6)
    S, _ = teng.score_all_packed([est], [sine], align="off", device=CPU)
    assert S[0, 0] == pytest.approx(kept, abs=1e-6)
