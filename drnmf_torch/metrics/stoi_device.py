"""STOI wholly on the device: resampling, silent-frame removal and the
correlations (counterpart of ``drnmf_tpu/metrics/stoi_device.py``).

* Resampling 16 kHz -> 10 kHz is scipy.signal.resample_poly's polyphase
  scheme (up 5, down 8, its firwin kaiser-5.0 filter of half-length 80 a
  rate, designed once with scipy at import).  Output ``j`` of the
  upsampled-and-filtered signal is ``sum_i x[i] h[8j - 5i]``; grouping the
  outputs by five (``j = 5a + b``) makes it ``sum_c x[8a + c] G[c, b]``
  with ``G[c, b] = h[8b - 5c]``, a product of each 40-sample window at hop
  8 with one (40, 5) matrix.  The windows are five consecutive 8-sample
  blocks, so the filter is five ``matmul`` of the block view (float32,
  TF32 off: ``device.resolve_device``), no convolution library.
* Silent-frame removal keeps the canonical semantics: windowed 256/128
  frames, energy threshold against the loudest valid frame, survivors
  overlap-added contiguously.  The survivors of rank k start at k * HOP,
  so output block j is the first half of the surviving frame of rank j
  plus the second half of the one of rank j - 1: a gather, not a scatter,
  and deterministic.
"""

import numpy as np
import scipy.signal
import torch

from ..device import resolve_device
from .bss_eval import _next_pow2
from .fused import _unpack, pack_pair, to_device
from .stoi import (DYN_RANGE_DB, FRAME, FS_STOI, HOP, SEG_FRAMES, _WINDOW,
                   _band_envelopes, _segment_scores, hop_frames)

_UP, _DOWN = 5, 8  # 16 kHz -> 10 kHz


def _design_resampler(up, down):
    """scipy.signal.resample_poly's filter + alignment constants
    (firwin(2*10*max_rate + 1, 1/max_rate, kaiser beta 5.0) * up)."""
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = scipy.signal.firwin(2 * half_len + 1, 1.0 / max_rate,
                            window=("kaiser", 5.0)) * up
    n_pre_pad = down - half_len % down
    n_pre_remove = (half_len + n_pre_pad) // down
    h_pad = np.concatenate([np.zeros(n_pre_pad), h]).astype(np.float32)
    return h_pad, n_pre_remove


_H_PAD, _N_PRE_REMOVE = _design_resampler(_UP, _DOWN)


def _polyphase_matrix(h, up, down):
    """(G, c_min): G[c - c_min, b] = h[down*b - up*c] where that index is
    in the filter, else 0; c runs over every input offset that reaches an
    output of a group of ``up``."""
    k = len(h)
    c_min = -((k - 1) // up)
    c_max = (down * (up - 1)) // up
    span = -(-(c_max - c_min + 1) // down) * down  # whole blocks of down
    g = np.zeros((span, up), np.float32)
    for ci in range(span):
        for b in range(up):
            t = down * b - up * (ci + c_min)
            if 0 <= t < k:
                g[ci, b] = h[t]
    return g, c_min


_G, _C_MIN = _polyphase_matrix(_H_PAD, _UP, _DOWN)


def resample_rows_16k_to_10k(rows, lengths):
    """(B, L) zero-padded rows at 16 kHz -> ((B, L10) rows at 10 kHz, new
    valid lengths ceil(n*5/8)); the math of
    scipy.signal.resample_poly(x[:n], 5, 8) in float32."""
    B, L = rows.shape
    L10 = -(-L * _UP // _DOWN)
    # outputs j = _N_PRE_REMOVE ... _N_PRE_REMOVE + L10 - 1 of the filter,
    # in groups of _UP
    a0 = _N_PRE_REMOVE // _UP
    n_groups = -(-(_N_PRE_REMOVE + L10) // _UP) - a0
    n_taps = _G.shape[0] // _DOWN  # blocks a window spans
    # x_pad[p] = x[p + _C_MIN + _DOWN * a0] (lead is 17 samples): group
    # a's window starts at block a - a0
    lead = -_C_MIN - _DOWN * a0
    total = (n_groups + n_taps - 1) * _DOWN
    x = torch.nn.functional.pad(rows, (lead, max(total - lead - L, 0)))
    blocks = x[:, :total].reshape(B, -1, _DOWN)
    g = torch.as_tensor(_G, device=rows.device).reshape(n_taps, _DOWN, _UP)
    out = torch.matmul(blocks[:, :n_groups], g[0])
    for s in range(1, n_taps):
        out = out + torch.matmul(blocks[:, s: s + n_groups], g[s])
    out = out.reshape(B, -1)
    start = _N_PRE_REMOVE - a0 * _UP
    res = out[:, start: start + L10]
    n10 = -((-lengths * _UP) // _DOWN)  # ceil(n*up/down)
    keep = torch.arange(L10, device=rows.device)[None, :] < n10[:, None]
    return torch.where(keep, res, 0.0), n10


def _remove_silent_rows(xf, yf, m):
    """Silent-frame removal of windowed (B, T, FRAME) frames with ``m``
    (B,) valid frames: survivors (clean-frame energy within DYN_RANGE_DB of
    the loudest valid frame) overlap-added contiguously into (B,
    (T + 1) * HOP) rows.  Returns (xs, ys, surviving frames (B,))."""
    B, T, _ = xf.shape
    tv = torch.arange(T, device=xf.device)[None, :] < m[:, None]
    energy = 20.0 * torch.log10(
        torch.sqrt(torch.sum(xf * xf, dim=-1)) + 1e-30)
    peak = torch.amax(torch.where(tv, energy, -np.inf), dim=-1, keepdim=True)
    keep = (energy > peak - DYN_RANGE_DB) & tv
    m2 = torch.sum(keep, dim=-1)
    # the kept frames' indices first, in order: rank k -> frame src[k]
    src = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    live = (torch.arange(T, device=xf.device)[None, :] < m2[:, None])

    def ola(fr):
        ranked = fr.gather(1, src[:, :, None].expand(-1, -1, FRAME))
        ranked = torch.where(live[:, :, None], ranked, 0.0)
        first = torch.nn.functional.pad(ranked[:, :, :HOP], (0, 0, 0, 1))
        second = torch.nn.functional.pad(ranked[:, :, HOP:], (0, 0, 1, 0))
        return (first + second).reshape(B, -1)

    return ola(xf), ola(yf), m2


def stoi_rows(ref_rows, est_rows, lengths, fs: int = 16000):
    """(B,) STOI scores of zero-padded (B, L) rows with (B,) lengths, all on
    the rows' device.  ``fs`` must be 16000 (resampled here) or 10000."""
    if fs == 16000:
        ref10, n10 = resample_rows_16k_to_10k(ref_rows, lengths)
        est10, _ = resample_rows_16k_to_10k(est_rows, lengths)
    elif fs == FS_STOI:
        ref10, est10, n10 = ref_rows, est_rows, lengths
    else:
        raise ValueError(f"device STOI supports fs 16000/10000, got {fs}")
    pad = (-ref10.shape[1]) % HOP
    if pad:
        ref10 = torch.nn.functional.pad(ref10, (0, pad))
        est10 = torch.nn.functional.pad(est10, (0, pad))

    w = torch.as_tensor(_WINDOW, device=ref_rows.device)
    m = torch.clamp((n10 - FRAME) // HOP + 1, min=0)  # valid frames
    xs, ys, m2 = _remove_silent_rows(hop_frames(ref10, FRAME) * w,
                                     hop_frames(est10, FRAME) * w, m)
    # band envelopes of the re-framed survivors, then the segments
    xb = _band_envelopes(hop_frames(xs, FRAME) * w)
    yb = _band_envelopes(hop_frames(ys, FRAME) * w)
    score = _segment_scores(xb, yb, m2)
    return torch.where(m2 < SEG_FRAMES, float("nan"), score)


def stoi_packed_device(ref_list, est_list, fs: int = 16000, device="cuda"):
    """(n_files,) STOI wholly on the device: one packed transfer and one
    pass a power-of-two length bucket (where ``stoi.stoi_packed`` resamples
    and removes silent frames on the host)."""
    device = resolve_device(device)
    n_files = len(ref_list)
    out = np.full(n_files, np.nan)
    lens = np.zeros(n_files, np.int64)
    buckets = {}
    for i, (r, e) in enumerate(zip(ref_list, est_list)):
        lens[i] = min(len(r), len(e))
        buckets.setdefault(max(_next_pow2(lens[i]), 1024), []).append(i)
    pending = []
    for L, idxs in sorted(buckets.items()):
        ref_c, est_c, offsets = pack_pair(ref_list, est_list, idxs, lens)
        ref_c, est_c, off, n_t = (to_device(a, device) for a in (
            ref_c, est_c, offsets, lens[idxs]))
        pending.append((idxs, stoi_rows(_unpack(ref_c, off, n_t, L),
                                        _unpack(est_c, off, n_t, L), n_t,
                                        fs=fs)))
    for idxs, res in pending:
        out[np.asarray(idxs)] = res.cpu().numpy()
    return out
