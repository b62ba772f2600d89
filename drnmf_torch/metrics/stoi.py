"""STOI: short-time objective intelligibility (Taal, Hendriks, Heusdens,
Jensen, IEEE TASLP 2011); counterpart of ``drnmf_tpu/metrics/stoi.py``.

Replaces the MATLAB ``stoi`` toolbox call in the reference's scoring stack
(score_audio.m:231).  Canonical algorithm:

1. resample both signals to 10 kHz;
2. remove frames whose clean-signal energy is > 40 dB below the loudest
   frame (256-sample Hann frames, 50% overlap), overlap-adding the survivors;
3. STFT (256-sample frames, hop 128, FFT 512);
4. group bins into 15 one-third-octave bands (lowest center 150 Hz);
5. for every 30-frame (384 ms) segment and band: normalize the degraded
   band envelope to the clean energy, clip at -15 dB SDR, and correlate with
   the clean envelope;
6. STOI = mean correlation over all bands and segments.

Here the data-dependent steps (resampling, silent-frame removal) run on the
host in numpy and scipy, as in the JAX package; the spectra and the
band/segment correlations run in PyTorch on the device.
``stoi_device.py`` moves the host steps onto the device too.
"""

import numpy as np
import scipy.signal
import torch

from ..device import resolve_device

FS_STOI = 10000
N_FFT = 512
FRAME = 256
HOP = 128
N_BANDS = 15
CF_MIN = 150.0
SEG_FRAMES = 30  # 384 ms
BETA_DB = -15.0
DYN_RANGE_DB = 40.0


def _thirdoct_matrix():
    """(N_BANDS, N_FFT//2+1) 0/1 band-grouping matrix."""
    f = np.linspace(0, FS_STOI / 2, N_FFT // 2 + 1)
    k = np.arange(N_BANDS)
    cf = CF_MIN * 2.0 ** (k / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    H = np.zeros((N_BANDS, len(f)), np.float32)
    for j in range(N_BANDS):
        # canonical implementation: nearest bin to each band edge
        i_lo = np.argmin((f - lo[j]) ** 2)
        i_hi = np.argmin((f - hi[j]) ** 2)
        H[j, i_lo:i_hi] = 1.0
    return H


_H_BANDS = _thirdoct_matrix()
_WINDOW = np.hanning(FRAME + 2)[1:-1].astype(np.float32)


def _frames(x, flen=FRAME, hop=HOP):
    n = (len(x) - flen) // hop + 1
    if n <= 0:
        return np.zeros((0, flen), np.float32)
    idx = np.arange(n)[:, None] * hop + np.arange(flen)[None, :]
    return x[idx]


def _remove_silent_frames(x, y):
    """Drop frames where the clean signal is >40 dB below its loudest frame,
    overlap-adding the survivors (canonical removeSilentFrames)."""
    w = np.hanning(FRAME + 2)[1:-1].astype(np.float32)
    xf = _frames(x) * w
    yf = _frames(y) * w
    if xf.shape[0] == 0:
        return x, y
    energy = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-30)
    keep = energy > (np.max(energy) - DYN_RANGE_DB)
    xf, yf = xf[keep], yf[keep]
    n_keep = xf.shape[0]
    out_len = FRAME + (n_keep - 1) * HOP if n_keep else 0
    xs = np.zeros(out_len, np.float32)
    ys = np.zeros(out_len, np.float32)
    for i in range(n_keep):
        xs[i * HOP : i * HOP + FRAME] += xf[i]
        ys[i * HOP : i * HOP + FRAME] += yf[i]
    return xs, ys


def _band_envelopes(frames):
    """(..., n_frames, FRAME) windowed frames -> (..., N_BANDS, n_frames)
    one-third-octave band envelopes."""
    power = torch.fft.rfft(frames, n=N_FFT, dim=-1).abs() ** 2
    hb = torch.as_tensor(_H_BANDS, device=frames.device)
    return torch.sqrt(torch.matmul(power, hb.T)).transpose(-1, -2)


def _segment_scores(xb, yb, m_valid):
    """(B,) mean segment correlation of (B, N_BANDS, M) zero-padded band
    envelopes over each row's ``m_valid`` (B,) true frames.  The segments
    are one (B, N_BANDS, n_seg, SEG_FRAMES) gather."""
    n_seg = max(xb.shape[-1] - SEG_FRAMES + 1, 0)  # none in a short row
    ar = torch.arange(n_seg, device=xb.device)
    idx = ar[:, None] + torch.arange(SEG_FRAMES, device=xb.device)[None, :]
    xs = xb[:, :, idx]
    ys = yb[:, :, idx]
    alpha = torch.sqrt(
        torch.sum(xs**2, dim=-1, keepdim=True)
        / torch.clamp(torch.sum(ys**2, dim=-1, keepdim=True), min=1e-30))
    ys_c = torch.minimum(ys * alpha, xs * (1.0 + 10.0 ** (-BETA_DB / 20.0)))
    xm = xs - torch.mean(xs, dim=-1, keepdim=True)
    ym = ys_c - torch.mean(ys_c, dim=-1, keepdim=True)
    num = torch.sum(xm * ym, dim=-1)
    den = torch.sqrt(torch.sum(xm**2, dim=-1) * torch.sum(ym**2, dim=-1))
    d = num / torch.clamp(den, min=1e-30)  # (B, N_BANDS, n_seg)
    seg_means = torch.mean(d, dim=1)
    valid = (ar[None, :] < (m_valid[:, None] - SEG_FRAMES + 1)).to(xb.dtype)
    return (torch.sum(seg_means * valid, dim=1)
            / torch.clamp(torch.sum(valid, dim=1), min=1.0))


def _stoi_from_envelopes(xb, yb, m_valid):
    """Mean segment correlation of one pair's (N_BANDS, M) zero-padded
    envelopes over its ``m_valid`` true frames."""
    m = torch.as_tensor([int(m_valid)], device=xb.device)
    return _segment_scores(xb[None], yb[None], m)[0]


def _host_stage(ref, est, fs):
    """Data-dependent host preprocessing shared by the per-file and packed
    paths: truncate to common length, resample to 10 kHz, remove silent
    frames.  Returns (ref_sig, est_sig, m frames)."""
    ref = np.asarray(ref, np.float64).ravel()
    est = np.asarray(est, np.float64).ravel()
    n = min(len(ref), len(est))
    ref, est = ref[:n], est[:n]
    if fs != FS_STOI:
        ref = scipy.signal.resample_poly(ref, FS_STOI, fs)
        est = scipy.signal.resample_poly(est, FS_STOI, fs)
    ref, est = _remove_silent_frames(
        ref.astype(np.float32), est.astype(np.float32)
    )
    m = (len(ref) - FRAME) // HOP + 1 if len(ref) >= FRAME else 0
    return ref, est, m


def stoi(ref, est, fs: int = 16000, device="cuda") -> float:
    """STOI score in [~0, 1] of one pair; ``ref`` is the clean signal.
    NaN for a pair shorter than one segment after silent-frame removal."""
    device = resolve_device(device)
    ref, est, m = _host_stage(ref, est, fs)
    if m < SEG_FRAMES:
        return float("nan")
    xf = _frames(ref) * _WINDOW
    yf = _frames(est) * _WINDOW
    # frame counts padded to a power of two, as the JAX package buckets
    # them (zero frames past m are masked out)
    m_pad = 1 << max(int(m - 1).bit_length(), 5)
    xf = np.pad(xf, ((0, m_pad - m), (0, 0)))
    yf = np.pad(yf, ((0, m_pad - m), (0, 0)))
    xb = _band_envelopes(torch.from_numpy(xf).to(device))
    yb = _band_envelopes(torch.from_numpy(yf).to(device))
    return float(_stoi_from_envelopes(xb, yb, m))


def hop_frames(rows, flen):
    """(B, L) rows -> (B, L/hop - 1, flen) frames at hop = flen/2: each
    frame is two consecutive hop blocks (no gather)."""
    blocks = rows.reshape(rows.shape[0], -1, flen // 2)
    return torch.cat([blocks[:, :-1], blocks[:, 1:]], dim=-1)


def _stoi_packed_rows(ref_c, est_c, offsets, n_samples, m_valid, m_pad):
    """(B,) STOI scores from packed 1-D buffers of the silent-removed
    10 kHz signals: frames by the hop-block reshape (FRAME = 2 HOP), then
    one gather of the segments."""
    from .fused import _unpack

    L = (m_pad + 1) * HOP  # holds FRAME + (m_pad-1)*HOP samples
    w = torch.as_tensor(_WINDOW, device=ref_c.device)
    xb = _band_envelopes(hop_frames(_unpack(ref_c, offsets, n_samples, L),
                                    FRAME) * w)
    yb = _band_envelopes(hop_frames(_unpack(est_c, offsets, n_samples, L),
                                    FRAME) * w)
    return _segment_scores(xb, yb, m_valid)


def stoi_packed(ref_list, est_list, fs: int = 16000, pool=None,
                device="cuda"):
    """(n_files,) STOI scores: the host stage a file (on ``pool``, a
    concurrent.futures executor, where given), then one packed transfer and
    one batched pass a frame-count bucket.  Files shorter than one segment
    score NaN like the per-file path."""
    from .fused import to_device

    device = resolve_device(device)
    if pool is not None:
        staged = list(pool.map(lambda p: _host_stage(p[0], p[1], fs),
                               zip(ref_list, est_list)))
    else:
        staged = [_host_stage(r, e, fs) for r, e in zip(ref_list, est_list)]

    out = np.full(len(staged), np.nan)
    buckets = {}
    for i, (_, _, m) in enumerate(staged):
        if m >= SEG_FRAMES:
            m_pad = 1 << max(int(m - 1).bit_length(), 5)
            buckets.setdefault(m_pad, []).append(i)
    pending = []
    for m_pad, idxs in sorted(buckets.items()):
        lens = np.array([len(staged[i][0]) for i in idxs], np.int64)
        offsets = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
        ref_c = np.zeros(int(lens.sum()) + 1, np.float32)
        est_c = np.zeros(int(lens.sum()) + 1, np.float32)
        for row, i in enumerate(idxs):
            o, n = offsets[row], lens[row]
            ref_c[o : o + n] = staged[i][0]
            est_c[o : o + n] = staged[i][1]
        m_valid = np.array([staged[i][2] for i in idxs], np.int64)
        res = _stoi_packed_rows(*(to_device(a, device) for a in (
            ref_c, est_c, offsets, lens, m_valid)), m_pad=m_pad)
        pending.append((idxs, res))  # every bucket queued before a read
    for idxs, res in pending:
        out[np.asarray(idxs)] = res.cpu().numpy()
    return out
