"""SNR and segmental SNR (counterpart of ``drnmf_tpu/metrics/snr.py``).

* ``snr``: raw SNR, exactly the reference's formula (score_audio.m:209):
  ``10 log10( sum(ref^2) / sum((ref-est)^2) )``, in float64 numpy.

* ``snrseg``: segmental SNR in the voicebox ``snrseg(est, ref, fs)`` role
  (score_audio.m:212), the classical definition: non-overlapping 10 ms
  frames, per-frame SNR ``10 log10(sum r^2 / sum (s-r)^2)`` clamped to
  [-10, 35] dB, with

  - 'local'  = mean of the clamped per-frame SNRs over *active* frames
    (frame energy within 40 dB of the loudest reference frame), and
  - 'global' = 10 log10 of summed signal/noise energies over active frames.

  A batch of zero-padded rows at once; frames past a row's length are
  masked out.
"""

import numpy as np
import torch

from ..device import resolve_device

SEG_MIN_DB = -10.0
SEG_MAX_DB = 35.0
VAD_RANGE_DB = 40.0


def snr(est, ref) -> float:
    est = np.asarray(est, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    n = min(len(est), len(ref))
    est, ref = est[:n], ref[:n]
    den = np.sum((ref - est) ** 2)
    return float(10.0 * np.log10(np.sum(ref**2) / max(den, 1e-30)))


def _snrseg_padded(est, ref, n_valid, frame_len):
    """(local (B,), global (B,)) of zero-padded (B, total) rows."""
    n_frames = est.shape[-1] // frame_len
    e = est[:, : n_frames * frame_len].reshape(-1, n_frames, frame_len)
    r = ref[:, : n_frames * frame_len].reshape(-1, n_frames, frame_len)
    t0 = torch.arange(n_frames, device=est.device) * frame_len
    full = (t0[None, :] + frame_len) <= n_valid[:, None]  # complete frames

    sig = torch.sum(r * r, dim=-1)
    noi = torch.sum((r - e) ** 2, dim=-1)
    # energy VAD relative to the loudest complete reference frame
    peak = torch.amax(torch.where(full, sig, 0.0), dim=-1, keepdim=True)
    active = full & (sig > peak * 10.0 ** (-VAD_RANGE_DB / 10.0))

    frame_snr = 10.0 * torch.log10(torch.clamp(sig, min=1e-30)
                                   / torch.clamp(noi, min=1e-30))
    frame_snr = torch.clamp(frame_snr, SEG_MIN_DB, SEG_MAX_DB)
    w = active.to(est.dtype)
    local = (torch.sum(frame_snr * w, dim=-1)
             / torch.clamp(torch.sum(w, dim=-1), min=1.0))
    glo = 10.0 * torch.log10(
        torch.clamp(torch.sum(sig * w, dim=-1), min=1e-30)
        / torch.clamp(torch.sum(noi * w, dim=-1), min=1e-30))
    return local, glo


def snrseg_batch(est_p, ref_p, lengths, fs: int = 16000, tf: float = 0.01,
                 device="cuda"):
    """Segmental SNR over a padded batch: ``est_p``/``ref_p`` (B, total)
    zero-padded, ``total`` a multiple of the frame; ``lengths`` (B,).
    Returns numpy (local (B,), global (B,))."""
    device = resolve_device(device)
    local, glo = _snrseg_padded(
        torch.as_tensor(np.asarray(est_p, np.float32), device=device),
        torch.as_tensor(np.asarray(ref_p, np.float32), device=device),
        torch.as_tensor(np.asarray(lengths, np.int64), device=device),
        int(round(tf * fs)))
    return local.cpu().numpy(), glo.cpu().numpy()


def snrseg(est, ref, fs: int = 16000, tf: float = 0.01, device="cuda"):
    """(local, global) segmental SNR in dB of one pair, zero-padded to a
    power-of-two length (the batched function masks frames past it)."""
    est = np.asarray(est, np.float32).ravel()
    ref = np.asarray(ref, np.float32).ravel()
    n = min(len(est), len(ref))
    frame_len = int(round(tf * fs))
    target = 1 << max(int(n - 1).bit_length(), 1)
    target += (-target) % frame_len
    local, glo = snrseg_batch(np.pad(est[:n], (0, target - n))[None],
                              np.pad(ref[:n], (0, target - n))[None], [n],
                              fs, tf, device=device)
    return float(local[0]), float(glo[0])
