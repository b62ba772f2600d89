"""The P.862-structured PESQ model over packed signal buckets, in PyTorch
(counterpart of ``drnmf_tpu/metrics/pesq_device.py``).

The batched form of ``_pesq_model.pesq_mos_aligned``, stage for stage:
level alignment to 1e7 in the 350-3250 Hz band, Hann 512/256 STFT, 49
Bark-band pitch power densities, partial frequency and smoothed gain
compensation, Zwicker loudness, deadzone/asymmetry disturbances, frame
emphasis, L6/L2 time aggregation and the linear MOS map, as masked
fixed-shape tensor math over a whole power-of-two bucket of rows.  The host
model computes in float64, this one in float32 (TF32 off); the two agree
to about 1e-3 MOS.  The smoothed gain compensation is a first-order
recurrence over frames, run as a loop over them (``smooth_gain``).

Frames come from the hop-block view (FRAME == 2 * HOP at both the 512/256
analysis and the 1024/512 level-alignment resolutions), so rows need only
be zero-padded to a multiple of 512: the SDR path's power-of-two buckets
are.
"""

import numpy as np
import torch

from ..device import resolve_device
from ._pesq_model import (_ABS_THRESH, _ASYM_SCALE, _GAMMA, _POWER_SCALE,
                          _SL, _SP, _SYM_SCALE, _WIDTH, _band_matrix,
                          _wb_input_weight)
from .bss_eval import _next_pow2
from .fused import _unpack, pack_pair, to_device
from .stoi import hop_frames as _hop_frames

_FLEN = 512
_HOP = 256
_ALIGN_FLEN = 1024


def _const(array, device):
    return torch.as_tensor(np.asarray(array, np.float32), device=device)


def _masked_hann_power(rows, lengths, fs, flen, lo, hi):
    """Per-row mean band power of ``rows`` over complete flen/2-hop frames
    (the level-alignment measurement, at flen=1024)."""
    w = _const(np.hanning(flen), rows.device)
    fr = _hop_frames(rows, flen)  # (B, T2, flen)
    p = torch.fft.rfft(fr * w, dim=-1).abs() ** 2  # (B, T2, F2)
    f = np.linspace(0, fs / 2, flen // 2 + 1)
    band = (f >= lo) & (f <= hi)
    m2 = torch.clamp((lengths - flen) // (flen // 2) + 1, min=0)
    t = torch.arange(fr.shape[1], device=rows.device)
    valid = (t[None, :] < m2[:, None]).to(rows.dtype)  # (B, T2)
    total = torch.einsum("btf,bt,f->b", p, valid,
                         _const(band, rows.device))
    count = torch.clamp(m2.to(rows.dtype) * float(np.sum(band)), min=1.0)
    return total / count


def _masked_lpq(x, m, split=20, p=6.0, q=2.0):
    """L6 over half-overlapped ~split-frame intervals (including the
    trailing partial ones, like the host model's ragged tail slices), L2
    over intervals.  x: (B, T) zero-padded frame series; m: (B,) valid
    frame counts."""
    T = x.shape[1]
    hopi = split // 2
    n_win = -(-T // hopi)
    starts = torch.arange(n_win, device=x.device) * hopi
    idx = starts[:, None] + torch.arange(split, device=x.device)[None, :]
    vals = x[:, torch.clamp(idx, 0, T - 1)]  # (B, W, split)
    elem_valid = (idx[None, :, :] < m[:, None, None]).to(x.dtype)
    cnt = torch.clamp(torch.sum(elem_valid, dim=-1), min=1.0)
    mean_p = torch.sum((vals**p) * elem_valid, dim=-1) / cnt
    win_val = mean_p ** (1.0 / p)
    win_valid = (starts[None, :] < m[:, None]).to(x.dtype)
    n_v = torch.clamp(torch.sum(win_valid, dim=-1), min=1.0)
    return (torch.sum((win_val**q) * win_valid, dim=-1) / n_v) ** (1.0 / q)


def smooth_gain(raw):
    """The first-order smoothing of the short-term gain over the frames of
    (B, T) ``raw``: s_t = 0.2 s_{t-1} + 0.8 raw_t from s = 1, a loop over
    the frames in float32, as the host model's."""
    scale = torch.empty_like(raw)
    s = torch.ones_like(raw[:, 0])
    for t in range(raw.shape[1]):
        s = 0.2 * s + 0.8 * raw[:, t]
        scale[:, t] = s
    return scale


def pesq_rows(ref_rows, deg_rows, lengths, fs: int = 16000):
    """(B,) MOS scores of zero-padded (B, L) signal rows (L a multiple of
    512) with (B,) valid lengths; NaN where the host model gives NaN (fewer
    than 4 frames, or fewer than 4 active ones)."""
    flen = _FLEN if fs == 16000 else _FLEN // 2
    device = ref_rows.device

    # level alignment in the power domain: scaling x by c scales every
    # power by c^2, so the factor applies to the frame powers directly
    p_ref = _masked_hann_power(ref_rows, lengths, fs, _ALIGN_FLEN, 350.,
                               3250.)
    p_deg = _masked_hann_power(deg_rows, lengths, fs, _ALIGN_FLEN, 350.,
                               3250.)
    factor_r = 1e7 / torch.clamp(p_ref, min=1e-12)
    factor_d = 1e7 / torch.clamp(p_deg, min=1e-12)

    # Hann 512/256 spectra, wideband input weight
    w = _const(np.hanning(flen), device)
    fr_r = _hop_frames(ref_rows, flen)  # (B, T, flen)
    fr_d = _hop_frames(deg_rows, flen)
    T = fr_r.shape[1]
    f = np.linspace(0, fs / 2, flen // 2 + 1)
    wb = _const(_wb_input_weight(f), device)
    rp = (torch.fft.rfft(fr_r * w, dim=-1).abs() ** 2) * wb \
        * factor_r[:, None, None]
    dp = (torch.fft.rfft(fr_d * w, dim=-1).abs() ** 2) * wb \
        * factor_d[:, None, None]

    m = torch.clamp((lengths - flen) // (flen // 2) + 1, min=0)  # frames
    tv = torch.arange(T, device=device)[None, :] < m[:, None]
    tvf = tv.to(ref_rows.dtype)

    # Bark pitch power densities
    M = _const(_band_matrix(fs, flen), device)  # (49, F)
    norm = float(np.float32(_SP * _POWER_SCALE
                            / np.mean(np.hanning(flen) ** 2)))
    rb = torch.matmul(rp, M.T) * norm * tvf[:, :, None]  # (B, T, 49)
    db = torch.matmul(dp, M.T) * norm * tvf[:, :, None]

    thresh = _const(_ABS_THRESH, device)

    def total_audible(pp, factor=1.0):
        return torch.sum(torch.where(pp > thresh * factor, pp, 0.0), dim=-1)

    # speech-active frames for the compensation averages
    audible_ref = total_audible(rb, 100.0)  # (B, T)
    primary = (audible_ref > 1e7) & tv
    n_primary = torch.sum(primary, dim=-1)
    rbsum = torch.sum(rb, dim=-1)
    peak = torch.amax(torch.where(tv, rbsum, 0.0), dim=-1, keepdim=True)
    fallback = (rbsum > peak * 1e-4) & tv
    n_fallback = torch.sum(fallback, dim=-1)
    use_primary = n_primary >= 4
    active = torch.where(use_primary[:, None], primary, fallback)
    n_active = torch.where(use_primary, n_primary, n_fallback)
    invalid = (m < 4) | (n_active < 4)  # the host model returns NaN here

    af = active.to(ref_rows.dtype)
    cnt = torch.clamp(n_active.to(ref_rows.dtype), min=1.0)[:, None]

    # partial frequency compensation of the reference
    mean_r = torch.einsum("btn,bt->bn", rb, af) / cnt
    mean_d = torch.einsum("btn,bt->bn", db, af) / cnt
    ratio = torch.clamp((mean_d + 1000.0) / (mean_r + 1000.0), 0.01, 100.0)
    rb_eq = rb * ratio[:, None, :]

    # smoothed short-term gain compensation
    raw = torch.clamp((total_audible(db) + 5e3)
                      / (total_audible(rb_eq) + 5e3), 3e-4, 5.0)  # (B, T)
    rb_eq = rb_eq * smooth_gain(raw)[:, :, None]

    # modified Zwicker loudness
    gam = _const(_GAMMA, device)

    def loudness(pp):
        l = _SL * (thresh / 0.5) ** gam * ((0.5 + 0.5 * pp / thresh) ** gam
                                           - 1.0)
        return torch.clamp(l, min=0.0)

    lr = loudness(rb_eq)
    ld = loudness(db)

    # deadzone-clipped disturbance + asymmetry
    d = ld - lr
    dead = 0.25 * torch.minimum(ld, lr)
    d = torch.where(d > dead, d - dead, torch.where(d < -dead, d + dead, 0.0))
    asym = ((db + 50.0) / (rb + 50.0)) ** 1.2
    asym = torch.where(asym < 3.0, 0.0, torch.clamp(asym, max=12.0))

    bw = _const(_WIDTH, device)
    wtot = float(np.float32(np.sum(_WIDTH)))
    d_sym = torch.sqrt(torch.sum((d * bw) ** 2, dim=-1) / wtot) * wtot
    d_asym = torch.sum(d.abs() * asym * bw, dim=-1)

    h = ((audible_ref + 1e5) / 1e7) ** 0.04
    d_sym = torch.clamp(_SYM_SCALE * d_sym / h, max=45.0) * tvf
    d_asym = torch.clamp(_ASYM_SCALE * d_asym / h, max=45.0) * tvf
    D = _masked_lpq(d_sym, m)
    DA = _masked_lpq(d_asym, m)
    mos = torch.clamp(4.5 - 0.1 * D - 0.0309 * DA, -0.5, 4.5)
    return torch.where(invalid, float("nan"), mos)


def pesq_packed(ref_list, deg_list, fs: int = 16000, device="cuda"):
    """(n_files,) PESQ MOS, batched on the device: one packed transfer and
    one pass a power-of-two length bucket."""
    device = resolve_device(device)
    n_files = len(ref_list)
    out = np.full(n_files, np.nan)
    lens = np.zeros(n_files, np.int64)
    buckets = {}
    for i, (r, dsig) in enumerate(zip(ref_list, deg_list)):
        lens[i] = min(len(r), len(dsig))
        buckets.setdefault(max(_next_pow2(lens[i]), 1024), []).append(i)
    pending = []
    for L, idxs in sorted(buckets.items()):
        ref_c, deg_c, offsets = pack_pair(ref_list, deg_list, idxs, lens)
        ref_c, deg_c, off, n_t = (to_device(a, device) for a in (
            ref_c, deg_c, offsets, lens[idxs]))
        pending.append((idxs, pesq_rows(_unpack(ref_c, off, n_t, L),
                                        _unpack(deg_c, off, n_t, L), n_t,
                                        fs=fs)))
    for idxs, res in pending:
        out[np.asarray(idxs)] = res.cpu().numpy()
    return out
