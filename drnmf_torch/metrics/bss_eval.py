"""BSS-Eval SDR in PyTorch (counterpart of ``drnmf_tpu/metrics/bss_eval.py``).

The single-source case of BSS Eval 3.0's ``bss_eval_sources`` (the metric
the reference computes through MATLAB, score_audio.m:206): the estimate is
decomposed as ``se = s_target + e_artif``, where ``s_target`` is the
least-squares projection of ``se`` onto the span of 512 delayed copies of
the reference, and

    SDR = 10 log10( ||s_target||^2 / ||se - s_target||^2 ).

A batch of zero-padded rows at once: the auto- and cross-correlations by
``torch.fft``, the 512 x 512 symmetric Toeplitz normal equations by a
batched Cholesky factorization and solve, the projection by FFT
convolution.

float32 conditioning: a relative diagonal loading (``ridge``, 1e-7 first)
keeps the factorization stable on most references; near-periodic ones are
rank-deficient in float32 and need a larger ridge.  A factorization that
fails must read as NaN: ``cholesky_ex`` reports it in ``info`` and returns
a partial factor, on which ``cholesky_solve`` gives a finite, wrong SDR
(near 0 dB), so each row with ``info > 0`` is set to NaN, and NaN is what
sends a row on to the next ridge (1e-5, then 1e-3).
"""

import numpy as np
import torch

from ..device import resolve_device

FLEN = 512
RIDGES = (1e-7, 1e-5, 1e-3)


def _next_pow2(n):
    return 1 << (int(n) - 1).bit_length()


def _sdr_padded(se, s, n_valid, flen=FLEN, ridge=1e-7):
    """(B,) SDR of zero-padded (B, nfft) float32 rows ``se`` against ``s``;
    ``n_valid`` (B,) their true lengths.  NaN where the factorization
    fails."""
    nfft = se.shape[-1]
    sf = torch.fft.rfft(s)
    sef = torch.fft.rfft(se)
    # autocorrelation r[k] = sum_t s[t] s[t-k]; cross-correlation
    # c[k] = sum_t se[t] s[t-k]
    r = torch.fft.irfft(sf * sf.conj(), n=nfft)[:, :flen]
    c = torch.fft.irfft(sef * sf.conj(), n=nfft)[:, :flen]

    ar = torch.arange(flen, device=se.device)
    idx = (ar[:, None] - ar[None, :]).abs()
    eye = torch.eye(flen, dtype=r.dtype, device=r.device)
    R = r[:, idx] + (ridge * r[:, :1, None] + 1e-30) * eye
    chol, info = torch.linalg.cholesky_ex(R)
    h = torch.cholesky_solve(c[:, :, None], chol)[:, :, 0]

    # s_target = h * s (filter), truncated to n_valid + flen - 1 like
    # bss_eval
    s_target = torch.fft.irfft(torch.fft.rfft(h, n=nfft) * sf, n=nfft)
    t = torch.arange(nfft, device=se.device)
    proj = t[None, :] < (n_valid[:, None] + flen - 1)
    s_target = torch.where(proj, s_target, 0.0)
    e = torch.where(proj, se - s_target, 0.0)
    num = torch.sum(s_target * s_target, dim=-1)
    den = torch.sum(e * e, dim=-1)
    sdr = 10.0 * torch.log10(num / torch.clamp(den, min=1e-30))
    return torch.where(info == 0, sdr, float("nan"))


def _padded_rows(arrays, nfft, device):
    rows = np.zeros((len(arrays), nfft), np.float32)
    for i, a in enumerate(arrays):
        rows[i, :len(a)] = a
    return torch.from_numpy(rows).to(device)


def bss_eval_sdr(se, s, flen: int = FLEN, device="cuda") -> float:
    """SDR of estimate ``se`` against reference ``s`` (1-D arrays), on
    ``device``."""
    device = resolve_device(device)
    se = np.asarray(se, np.float32).ravel()
    s = np.asarray(s, np.float32).ravel()
    n = min(len(se), len(s))
    nfft = _next_pow2(n + flen)
    se_p = _padded_rows([se[:n]], nfft, device)
    s_p = _padded_rows([s[:n]], nfft, device)
    n_t = torch.tensor([n], device=device)
    # near-periodic references make the Toeplitz system rank-deficient in
    # float32: escalate the relative ridge until the SDR is finite
    for ridge in RIDGES:
        val = float(_sdr_padded(se_p, s_p, n_t, flen=flen, ridge=ridge)[0])
        if np.isfinite(val):
            return val
    return val


def bss_eval_sdr_many(est_list, ref_list, flen: int = FLEN, device="cuda"):
    """SDR for many (est, ref) pairs, one batch a power-of-two FFT bucket;
    a non-finite entry is retried alone with the escalating ridge of
    :func:`bss_eval_sdr`."""
    device = resolve_device(device)
    out = np.zeros(len(est_list), np.float64)
    buckets = {}
    for i, (se, s) in enumerate(zip(est_list, ref_list)):
        buckets.setdefault(_next_pow2(min(len(se), len(s)) + flen),
                           []).append(i)
    for nfft, idxs in sorted(buckets.items()):
        lens = [min(len(est_list[i]), len(ref_list[i])) for i in idxs]
        ses = _padded_rows([np.asarray(est_list[i][:n], np.float32)
                            for i, n in zip(idxs, lens)], nfft, device)
        ss = _padded_rows([np.asarray(ref_list[i][:n], np.float32)
                           for i, n in zip(idxs, lens)], nfft, device)
        vals = _sdr_padded(ses, ss, torch.tensor(lens, device=device),
                           flen=flen).cpu().numpy()
        for row, i in enumerate(idxs):
            out[i] = (vals[row] if np.isfinite(vals[row])
                      else bss_eval_sdr(est_list[i], ref_list[i], flen=flen,
                                        device=device))
    return out
