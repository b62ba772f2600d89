"""Phase-augmented STFT features: the reference's optional unwrap path
(counterpart of ``drnmf_tpu/dsp/phase.py``).

* ``remove_hop_phase`` (util.py:234-242 of the reference): the phase is
  unwrapped along the frame axis, corrected so that re-wrapping gives the
  original angles exactly, and the linear term ``2*pi*(f/N)*(t*hop)`` (the
  phase a stationary sinusoid gains a hop) is subtracted.
* ``add_hop_phase`` (util.py:266-272): adds the term back.
* ``aug_stft`` / ``iaug_stft`` (util.py:228-281): the real-composite
  ``[real; imag]`` layout in and out.

Spectrograms are complex64 tensors, frame-major (..., n_frames, F), on any
device; ``numpy.unwrap``'s algorithm runs in float32.
"""

import math

import numpy as np
import torch

from ..device import resolve_device
from .stft import istft, stft
from .windows import sqrt_hann_periodic

_PERIOD = np.float32(2 * np.pi)
_HALF = _PERIOD / np.float32(2)


def _hop_phase(n_frames: int, f_bins: int, n_fft: int, hop: int,
               device) -> torch.Tensor:
    """Linear phase advance 2*pi*(f/N)*(t*hop), shape (n_frames, f_bins)."""
    frange = (torch.arange(f_bins, dtype=torch.float32, device=device)
              / float(np.float32(n_fft)))
    trange = torch.arange(n_frames, dtype=torch.float32,
                          device=device) * float(np.float32(hop))
    return 2.0 * math.pi * trange[:, None] * frange[None, :]


def unwrap(p: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``numpy.unwrap`` with period 2*pi along ``dim`` (float32)."""
    if p.shape[dim] == 0:
        return p
    period, half = float(_PERIOD), float(_HALF)
    dd = torch.diff(p, dim=dim)
    ddmod = torch.remainder(dd + half, period) - half
    ddmod = torch.where((ddmod == -half) & (dd > 0),
                        torch.full_like(ddmod, half), ddmod)
    correct = torch.where(dd.abs() < half, torch.zeros_like(dd), ddmod - dd)
    first = p.narrow(dim, 0, 1)
    rest = p.narrow(dim, 1, p.shape[dim] - 1) + torch.cumsum(correct, dim=dim)
    return torch.cat([first, rest], dim=dim)


def remove_hop_phase(spec: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Unwrap the phase over frames and remove the window-hop phases.
    ``spec``: complex (..., n_frames, F)."""
    ang = torch.angle(spec).to(torch.float32)
    phase = unwrap(ang, dim=-2)
    err = torch.angle(torch.polar(torch.ones_like(phase), phase)) - ang
    phase = phase - err
    phase = phase - _hop_phase(spec.shape[-2], spec.shape[-1], n_fft, hop,
                               spec.device)
    return torch.polar(spec.abs().to(torch.float32), phase)


def add_hop_phase(spec: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Inverse of :func:`remove_hop_phase` up to phase wrapping."""
    phase = torch.angle(spec).to(torch.float32)
    phase = phase + _hop_phase(spec.shape[-2], spec.shape[-1], n_fft, hop,
                               spec.device)
    return torch.polar(spec.abs().to(torch.float32), phase)


def aug_stft(x, n_fft: int, hop: int, flag_unwrap_phase: bool = False,
             window=None, device="cuda") -> np.ndarray:
    """Augmented STFT of a (possibly multichannel) signal's first channel:
    the real-composite ``(2F, n_frames)`` float32 array."""
    device = resolve_device(device)
    x = np.asarray(x, np.float32)
    if x.ndim == 2:
        x = x[0]
    if window is None:
        window = sqrt_hann_periodic(n_fft)
    spec = stft(torch.from_numpy(x).to(device), n_fft, hop,
                torch.as_tensor(np.asarray(window, np.float32),
                                device=device))  # (T, F)
    if flag_unwrap_phase:
        spec = remove_hop_phase(spec, n_fft, hop)
    spec = spec.T.cpu()  # (F, T)
    return torch.cat([spec.real, spec.imag], dim=0).numpy()


def iaug_stft(X, f_bins: int, nsrc: int, flag_unwrap_phase: bool = False,
              window=None, hop=None, device="cuda") -> np.ndarray:
    """Time series from an augmented STFT.  ``X``: real-composite
    ``(2*nsrc*nch*F, n_frames)``.  Returns ``(nsrc, nsampl, nch)``
    float32."""
    device = resolve_device(device)
    X = np.asarray(X, np.float32)
    n_fft = 2 * (f_bins - 1)
    if hop is None:
        hop = n_fft // 2
    if window is None:
        window = sqrt_hann_periodic(n_fft)
    window = torch.as_tensor(np.asarray(window, np.float32), device=device)
    n_reim = X.shape[0] // 2
    n_frames = X.shape[1]
    Xc = X[:n_reim] + 1j * X[n_reim:]
    nch = n_reim // (nsrc * f_bins)
    out = None
    for isrc in range(nsrc):
        xs = Xc[isrc * nch * f_bins: (isrc + 1) * nch * f_bins]
        # (nch*F, T) stored channel-major like compute_stfts -> (nch, F, T)
        xs = xs.reshape(f_bins, nch, n_frames, order="F")
        spec = torch.from_numpy(np.ascontiguousarray(
            np.transpose(xs, (1, 2, 0)).astype(np.complex64))).to(device)
        if flag_unwrap_phase:
            spec = add_hop_phase(spec, n_fft, hop)
        xr = istft(spec, n_fft, hop, window).cpu().numpy()  # (nch, n)
        if out is None:
            out = np.zeros((nsrc, xr.shape[1], nch), np.float32)
        out[isrc] = xr.T
    return out
