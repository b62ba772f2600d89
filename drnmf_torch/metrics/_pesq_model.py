"""P.862-structured perceptual model for time-aligned signals (see pesq.py).

The port's own copy of ``drnmf_tpu/metrics/_pesq_model.py`` (numpy only),
bit-equal to it; ``pesq_device.py`` is its batched PyTorch form.

Replaces the reference's ``pesq_16kHz`` MATLAB/Loizou toolbox call
(score_audio.m:225).  Pipeline, following ITU-T P.862 (16 kHz mode)
component by component:

  level align (350-3250 Hz band to 1e7) -> Hann STFT (512/256) ->
  Bark-band pitch power densities (49 bands, standard centre/width tables)
  -> partial frequency compensation of the reference (clip [0.01, 100]) ->
  smoothed short-term gain compensation (clip [3e-4, 5]) -> loudness via
  the modified Zwicker law with the per-band absolute-threshold table ->
  deadzone-clipped symmetric + asymmetry-weighted disturbances ->
  per-frame audible-power weighting and 45-cap -> L6-over-split-second /
  L2-over-utterance aggregation -> MOS = 4.5 - 0.1*D - 0.0309*DA (the
  standard's *linear* map; no bespoke power law).

Known deviations from the ITU reference implementation (documented, all
second-order for sample-aligned signals):

* the crude/fine time-alignment and bad-interval re-alignment machinery is
  omitted -- mask-based enhancement outputs are sample-aligned with their
  references by construction (STFT -> mask -> iSTFT of the same file);
* the wideband input filter is a frequency-domain ~100 Hz high-pass
  approximation of the P.862.2 IIR prefilter;
* three scalar constants absorb convention differences from the ITU DSP
  chain that cannot be pinned offline: ``_POWER_SCALE`` (absolute level of
  the pitch power densities -- the ITU level-equalization chain), and
  ``_SYM_SCALE`` / ``_ASYM_SCALE`` (the normalization of the standard's
  ``pseudo_Lp`` band aggregation at p=2 / p=1).  They are the only fitted
  constants; everything nonlinear (thresholds, Zwicker exponents, deadzone,
  asymmetry gates, caps, Lp orders, the MOS map) is the standard's.  Pinned
  by the published speech+white-noise MOS-vs-SNR anchor test
  (test_pesq_snr_anchor_curve, <=0.15 MOS).

Anchor coverage (tests/test_metrics.py): SIX distortion families --
additive white noise (the only family with published offline absolutes;
worst-case 0.15 MOS there, 0.10 at the fitted constants), mask-style
musical noise + spectral deletion, reverberation/time-smearing, MNRU
multiplicative noise (P.862's own reference degradation), amplitude
clipping, and packet-loss dropouts.  The five unpublished families pin
STRUCTURE: monotone degradation with severity and cross-family rank
consistency (including the standard's asymmetry -- deletions penalized
far less than additions).  No ITU conformance vectors are available
offline, so absolute calibration beyond the SNR family cannot be
measured here; the three fitted scalars transfer across all six families
without re-fitting, which is the saturation evidence for the 3-scalar
closure (adding per-family constants could not be validated against
anything).

Scores are therefore comparable between systems scored by this module and
land on the published MOS scale, though they are not bit-identical to ITU
reference binaries.
"""

import numpy as np

_SL = 1.866055e-1  # loudness scale (P.862 Sl, 16 kHz mode)
_SP = 6.910853e-6  # power-density scale (P.862 Sp, 16 kHz mode)
# calibration constants (see module docstring; fitted to the SNR anchors --
# max anchor error 0.10 MOS at these values)
_POWER_SCALE = 2000.0
_SYM_SCALE = 0.3
_ASYM_SCALE = 0.1
_ZWICKER = 0.23
_N_BARK = 49

# P.862 16 kHz band layout: 49 bands, contiguous in the (modified) Bark
# domain; centres/widths follow the standard's tables.
_WIDTH = np.array([
    0.157344, 0.317994, 0.322441, 0.326934, 0.331474, 0.336061, 0.340697,
    0.345381, 0.350114, 0.354897, 0.359729, 0.364611, 0.369544, 0.374529,
    0.379565, 0.384653, 0.389794, 0.394989, 0.400236, 0.405538, 0.410894,
    0.416306, 0.421773, 0.427297, 0.432877, 0.438514, 0.444209, 0.449962,
    0.455774, 0.461645, 0.467577, 0.473569, 0.479621, 0.485736, 0.491912,
    0.498151, 0.504454, 0.510819, 0.517250, 0.523745, 0.530308, 0.536934,
    0.543629, 0.550390, 0.557220, 0.564119, 0.571085, 0.578125, 0.585232,
])
_EDGES = np.concatenate([[0.0], np.cumsum(_WIDTH)])
_CENTRE = 0.5 * (_EDGES[:-1] + _EDGES[1:])

# Absolute hearing threshold per band (power units on the internal scale).
# P.862 tabulates these; they follow the threshold-in-quiet curve -- huge at
# low frequencies (killing hum bands), minimum around 2-4 kHz.
_ABS_THRESH = np.array([
    51286152.0, 2454709.5, 70794.59375, 4897.788574, 1174.897705,
    389.045166, 104.712860, 45.708820, 17.782795, 9.772372, 4.897789,
    3.090296, 1.905461, 1.258925, 0.977237, 0.724436, 0.562341, 0.457088,
    0.389045, 0.331131, 0.295121, 0.269153, 0.257040, 0.251189, 0.251189,
    0.251189, 0.251189, 0.263027, 0.288403, 0.309030, 0.338844, 0.371535,
    0.398107, 0.436516, 0.467735, 0.489779, 0.501187, 0.501187, 0.512861,
    0.524807, 0.524807, 0.524807, 0.512861, 0.478630, 0.426580, 0.371535,
    0.363078, 0.416869, 0.537032,
])

# Modified Zwicker exponent (P.862): boosted below 4 Bark.
_h = np.where(_CENTRE < 4.0, np.minimum(6.0 / (_CENTRE + 2.0), 2.0), 1.0)
_GAMMA = _ZWICKER * np.power(np.maximum(_h, 1.0), 0.15)


def _bark(f):
    """Zwicker Bark scale (consistent with the 49-band layout: 8 kHz ->
    ~21.3 Bark ~= the last band's upper edge)."""
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _band_matrix(fs, n_fft):
    """(49, F) matrix summing FFT-bin powers into the Bark bands."""
    f = np.linspace(0, fs / 2, n_fft // 2 + 1)
    z = _bark(f)
    M = np.zeros((_N_BARK, len(f)))
    idx = np.clip(np.searchsorted(_EDGES, z, side="right") - 1, 0, _N_BARK - 1)
    M[idx, np.arange(len(f))] = 1.0
    M[:, 0] = 0.0  # DC carries no pitch power
    return M


def _frames(x, flen, hop):
    n = max(0, (len(x) - flen) // hop + 1)
    idx = np.arange(n)[:, None] * hop + np.arange(flen)[None, :]
    return x[idx]


def _wb_input_weight(f):
    """Frequency response (power) approximating the P.862.2 wideband input
    high-pass (cuts below ~100 Hz, flat passband)."""
    h = np.clip((f - 50.0) / 100.0, 0.0, 1.0)
    return h * h


def _level_align(x, fs):
    """Scale to the standard's target power (1e7) in the 350-3250 Hz band."""
    n_fft = 1024
    spec = np.fft.rfft(_frames(x, n_fft, n_fft // 2) * np.hanning(n_fft), axis=-1)
    f = np.linspace(0, fs / 2, n_fft // 2 + 1)
    band = (f >= 350) & (f <= 3250)
    p = np.mean(np.abs(spec[:, band]) ** 2)
    return x * np.sqrt(1e7 / max(p, 1e-12))


def _total_audible(pp, factor=1.0):
    """Per-frame sum of band powers above factor*absolute threshold."""
    return np.sum(np.where(pp > _ABS_THRESH[None, :] * factor, pp, 0.0), axis=1)


def _loudness(pp):
    """Modified Zwicker loudness per band (P.862 intensity warping)."""
    t = _ABS_THRESH[None, :]
    g = _GAMMA[None, :]
    l = _SL * (t / 0.5) ** g * ((0.5 + 0.5 * pp / t) ** g - 1.0)
    return np.maximum(l, 0.0)


def _lpq_time(x, split=20, p=6.0, q=2.0):
    """L6 over half-overlapped ~split-second intervals, L2 over intervals."""
    m = len(x)
    if m == 0:
        return 0.0
    hopi = max(1, split // 2)
    vals = []
    for start in range(0, m, hopi):
        seg = x[start : start + split]
        vals.append((np.mean(seg**p)) ** (1.0 / p))
    vals = np.asarray(vals)
    return float((np.mean(vals**q)) ** (1.0 / q))


def _disturbance_frames(ref, deg, fs=16000):
    """Per-frame raw symmetric/asymmetric disturbances plus the frame
    emphasis weight.  Returns (d_sym, d_asym, h) or None for degenerate
    input."""
    flen = 512 if fs == 16000 else 256
    hop = flen // 2
    n = min(len(ref), len(deg))
    ref, deg = ref[:n] * 32768.0, deg[:n] * 32768.0  # integer-scale convention

    ref = _level_align(ref, fs)
    deg = _level_align(deg, fs)

    w = np.hanning(flen)
    rf = np.fft.rfft(_frames(ref, flen, hop) * w, axis=-1)
    df = np.fft.rfft(_frames(deg, flen, hop) * w, axis=-1)
    n_frames = min(rf.shape[0], df.shape[0])
    if n_frames < 4:
        return None
    f = np.linspace(0, fs / 2, flen // 2 + 1)
    wb = _wb_input_weight(f)[None, :]
    rp = (np.abs(rf[:n_frames]) ** 2) * wb
    dp = (np.abs(df[:n_frames]) ** 2) * wb

    # pitch power densities (Sp-scaled band sums); the window's power gain
    # (mean(w^2) = 3/8 for Hann) is divided out so the densities sit on the
    # standard's absolute scale, then _POWER_SCALE calibrates the remainder
    M = _band_matrix(fs, flen)
    norm = _SP * _POWER_SCALE / np.mean(w**2)
    rb = (rp @ M.T) * norm  # (T, 49)
    db = (dp @ M.T) * norm

    # speech-active frames (used for the compensation averages): audible
    # reference power above the standard's silence criterion
    audible_ref = _total_audible(rb, factor=100.0)
    active = audible_ref > 1e7
    if active.sum() < 4:
        # very low-level material: fall back to an energy criterion
        active = rb.sum(axis=1) > rb.sum(axis=1).max() * 1e-4
        if active.sum() < 4:
            return None

    # partial frequency compensation: move the REFERENCE toward the degraded
    # time-averaged spectrum (removes linear filtering from the distortion),
    # per-band ratio clipped to [0.01, 100]
    mean_r = rb[active].mean(axis=0)
    mean_d = db[active].mean(axis=0)
    ratio = np.clip((mean_d + 1000.0) / (mean_r + 1000.0), 0.01, 100.0)
    rb_eq = rb * ratio[None, :]

    # short-term gain compensation of the reference (clip [3e-4, 5]), with
    # the standard's first-order smoothing over frames
    raw = np.clip(
        (_total_audible(db) + 5e3) / (_total_audible(rb_eq) + 5e3), 3e-4, 5.0
    )
    scale = np.empty_like(raw)
    s = 1.0
    for t in range(len(raw)):
        s = 0.2 * s + 0.8 * raw[t]
        scale[t] = s
    rb_eq = rb_eq * scale[:, None]

    lr = _loudness(rb_eq)
    ld = _loudness(db)

    # disturbance with the P.862 deadzone (0.25 * min of the two loudnesses)
    d = ld - lr
    dead = 0.25 * np.minimum(ld, lr)
    d = np.where(d > dead, d - dead, np.where(d < -dead, d + dead, 0.0))

    # asymmetry factor from the RAW pitch power densities:
    # ((deg+50)/(ref+50))^1.2; <3 -> 0, capped at 12
    asym = ((db + 50.0) / (rb + 50.0)) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))

    bw = _WIDTH[None, :]
    wtot = float(np.sum(_WIDTH))
    # symmetric frame disturbance: the standard's pseudo-Lp at p=2
    # (width-weighted L2 mean over Bark, rescaled by the total Bark width)
    d_sym = np.sqrt(np.sum((d * bw) ** 2, axis=1) / wtot) * wtot
    # asymmetric frame disturbance: pseudo-Lp at p=1 of the asym-weighted d
    d_asym = np.sum(np.abs(d) * asym * bw, axis=1)

    # frame emphasis by audible reference power (amplifies distortion
    # during quiet reference passages)
    h = ((audible_ref + 1e5) / 1e7) ** 0.04
    return d_sym, d_asym, h


def pesq_mos_aligned(ref, deg, fs=16000):
    out = _disturbance_frames(ref, deg, fs)
    if out is None:
        return float("nan")
    d_sym, d_asym, h = out
    # calibrated pseudo-Lp normalizations, frame emphasis, the standard's 45
    # cap, then L6/L2 time aggregation over the WHOLE signal (distortion in
    # reference silences counts, as in the standard)
    d_sym = np.minimum(_SYM_SCALE * d_sym / h, 45.0)
    d_asym = np.minimum(_ASYM_SCALE * d_asym / h, 45.0)
    D = _lpq_time(d_sym)
    DA = _lpq_time(d_asym)
    # the standard's linear map -- no bespoke power law
    mos = 4.5 - 0.1 * D - 0.0309 * DA
    return float(np.clip(mos, -0.5, 4.5))
