"""STFT and iSTFT of the reference (util.py's ``stft_mc`` and
``istft_mc(flag_noDiv=1)`` of the original): the signal zero-padded up to
a multiple of the hop and by n_fft on both edges, left-aligned frames
under the square root of the periodic Hann window, an rFFT; back, the
irFFT under the window scaled by 2/(n_fft/hop), plain overlap-add, n_fft
trimmed from both ends.  Signals of a batch are padded to the longest with
zeros: a zero tail adds zero frames, which change no earlier frame."""

import math

import torch


def sqrt_hann(n_fft, device):
    k = torch.arange(n_fft, dtype=torch.float64, device=device)
    return torch.sqrt(0.5 - 0.5 * torch.cos(2 * math.pi * k / n_fft)).float()


def n_frames(nsampl, n_fft, hop):
    """Frames of a signal of ``nsampl`` samples."""
    return 1 + (-(-nsampl // hop) * hop + n_fft) // hop


def stft(signals, n_fft, hop, device):
    """A list of 1-D float32 arrays -> (B, T, F) complex64 on ``device``,
    T the longest signal's frame count."""
    longest = max(len(s) for s in signals)
    total = -(-longest // hop) * hop + 2 * n_fft
    x = torch.zeros((len(signals), total), dtype=torch.float32,
                    device=device)
    for i, s in enumerate(signals):
        x[i, n_fft:n_fft + len(s)] = torch.as_tensor(s, device=device)
    frames = x.unfold(-1, n_fft, hop) * sqrt_hann(n_fft, device)
    return torch.fft.rfft(frames, dim=-1)


def istft(spec, n_fft, hop):
    """(B, T, F) complex -> (B, hop*(T-1)) float32: the overlap-added
    frames with n_fft trimmed from both ends."""
    b, t, _ = spec.shape
    window = sqrt_hann(n_fft, spec.device) * (2.0 / (n_fft / hop))
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    out = torch.zeros((b, n_fft + hop * (t - 1)), dtype=torch.float32,
                      device=spec.device)
    for i in range(t):
        out[:, i * hop:i * hop + n_fft] += frames[:, i]
    return out[:, n_fft:-n_fft]
