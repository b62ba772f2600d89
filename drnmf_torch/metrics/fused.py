"""SDR, SNR and segmental SNR of a batch of pairs in one pass
(counterpart of ``drnmf_tpu/metrics/fused.py``).

The three metrics share the SDR path's power-of-two padded rows.  Their
values are those of :func:`bss_eval.bss_eval_sdr`, :func:`snr.snr` (float32
here where that is float64: under 1e-3 dB) and :func:`snr.snrseg` called
alone.
"""

import numpy as np
import torch

from ..device import resolve_device
from .bss_eval import FLEN, RIDGES, _next_pow2, _sdr_padded, bss_eval_sdr
from .snr import _snrseg_padded


def pack_pair(a_list, b_list, idxs, lens, dtype=np.float32, convert=None):
    """Concat-buffer packing shared by every pow2-bucketed device program
    (fused / engine / pesq_device / stoi_device): the selected rows are
    packed back-to-back with a trailing zero guard row for the clip-mode
    unpack gather.  ``convert(x, n)`` overrides the per-row conversion
    (e.g. the engine's int16 or dequant paths).  Returns host arrays
    ``(a_c, b_c, offsets)``."""
    offsets = np.zeros(len(idxs), np.int64)
    pos = 0
    for row, i in enumerate(idxs):
        offsets[row] = pos
        pos += lens[i]
    a_c = np.empty(pos + 1, dtype)
    b_c = np.empty(pos + 1, dtype)
    a_c[-1] = b_c[-1] = 0
    conv = convert or (lambda x, n: np.asarray(x[:n], dtype))
    for row, i in enumerate(idxs):
        o, n = offsets[row], lens[i]
        a_c[o : o + n] = conv(a_list[i], n)
        b_c[o : o + n] = conv(b_list[i], n)
    return a_c, b_c, offsets


def to_device(array, device):
    """A host array on ``device``: on the card through a pinned buffer and
    a non-blocking copy."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _unpack(concat, offsets, lengths, nfft):
    """(B, nfft) zero-padded rows from a packed 1-D buffer: a gather with
    the indices clamped into the buffer, as the JAX package's clip mode."""
    idx = offsets[:, None] + torch.arange(nfft, device=concat.device)[None, :]
    rows = concat[torch.clamp(idx, 0, concat.shape[0] - 1)]
    valid = (torch.arange(nfft, device=concat.device)[None, :]
             < lengths[:, None])
    return torch.where(valid, rows, 0.0)


def fused_rows(se, s, n_valid, ridge, flen, frame_len):
    """(B, 4) [SDR, SNR, SegSNR local, SegSNR global] of zero-padded
    (B, nfft) rows at one ridge (the SDR NaN where its factorization
    fails)."""
    sdr = _sdr_padded(se, s, n_valid, flen=flen, ridge=ridge)
    valid = (torch.arange(se.shape[-1], device=se.device)[None, :]
             < n_valid[:, None])
    ref2 = torch.sum(torch.where(valid, s * s, 0.0), dim=-1)
    noi2 = torch.sum(torch.where(valid, (s - se) ** 2, 0.0), dim=-1)
    raw_snr = 10.0 * torch.log10(ref2 / torch.clamp(noi2, min=1e-30))
    loc, glo = _snrseg_padded(se, s, n_valid, frame_len)
    return torch.stack([sdr, raw_snr, loc, glo], dim=1)


def fused_device_metrics(est, ref, fs: int = 16000, flen: int = FLEN,
                         tf: float = 0.01, device="cuda"):
    """(SDR, SNR, SegSNR local, SegSNR global) of one time-aligned pair;
    the SDR ridge escalates like :func:`bss_eval.bss_eval_sdr`."""
    device = resolve_device(device)
    est = np.asarray(est, np.float32).ravel()
    ref = np.asarray(ref, np.float32).ravel()
    n = min(len(est), len(ref))
    est, ref = est[:n], ref[:n]
    frame_len = int(round(tf * fs))
    nfft = _next_pow2(n + flen)
    se_p = to_device(np.pad(est, (0, nfft - n))[None], device)
    s_p = to_device(np.pad(ref, (0, nfft - n))[None], device)
    n_t = torch.tensor([n], device=device)
    for ridge in RIDGES:
        vals = fused_rows(se_p, s_p, n_t, ridge, flen,
                          frame_len)[0].cpu().numpy().astype(np.float64)
        if np.isfinite(vals[0]):
            break
    if not np.isfinite(vals[0]):
        vals[0] = bss_eval_sdr(est, ref, flen=flen, device=device)
    return tuple(float(v) for v in vals)


def fused_metrics_packed(est_list, ref_list, fs: int = 16000,
                         flen: int = FLEN, tf: float = 0.01, device="cuda"):
    """(n_files, 4) [SDR, SNR, SegSNR local, SegSNR global] for many pairs.

    Per power-of-two FFT bucket the truncated signals go to the device as
    one packed buffer each, are unpacked into padded rows there, and the
    four metrics of the whole bucket run at once.  The ridge escalates a
    bucket at a time: each file keeps the value of the first ridge where
    its SDR is finite, as the per-file escalation does; a file still
    non-finite at the last ridge takes the exact per-file fallback
    (:func:`bss_eval.bss_eval_sdr`) for its SDR and keeps its other
    columns.  Every bucket of a round is queued before any result is
    read."""
    device = resolve_device(device)
    n_files = len(est_list)
    out = np.zeros((n_files, 4), np.float64)
    frame_len = int(round(tf * fs))
    buckets = {}
    lens = np.zeros(n_files, np.int64)
    for i, (se, s) in enumerate(zip(est_list, ref_list)):
        lens[i] = min(len(se), len(s))
        buckets.setdefault(_next_pow2(lens[i] + flen), []).append(i)

    work = []  # [nfft, idxs, device rows, pending mask]
    for nfft, idxs in sorted(buckets.items()):
        est_c, ref_c, offsets = pack_pair(est_list, ref_list, idxs, lens)
        est_c, ref_c, off, n_t = (to_device(a, device) for a in (
            est_c, ref_c, offsets, lens[idxs]))
        rows = (_unpack(est_c, off, n_t, nfft), _unpack(ref_c, off, n_t, nfft),
                n_t)
        work.append([nfft, np.asarray(idxs), rows, np.ones(len(idxs), bool)])

    for ridge in RIDGES:
        pending = [(w, fused_rows(*w[2], ridge, flen, frame_len))
                   for w in work if w[3].any()]
        for w, res in pending:
            vals = res.cpu().numpy().astype(np.float64)
            need = w[3]
            newly = need & np.isfinite(vals[:, 0])
            out[w[1][newly]] = vals[newly]
            need &= ~newly
            if need.any() and ridge == RIDGES[-1]:
                out[w[1][need]] = vals[need]
                for i in w[1][need]:
                    n = lens[i]
                    out[i, 0] = bss_eval_sdr(
                        np.asarray(est_list[i][:n], np.float32),
                        np.asarray(ref_list[i][:n], np.float32), flen=flen,
                        device=device)
    return out
