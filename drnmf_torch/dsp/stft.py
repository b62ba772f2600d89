"""STFT / iSTFT primitives with the reference's conventions.

* ``stft_mc`` (util.py:171-201): the signal is zero-padded up to a multiple of
  ``hop``, then padded with ``n_fft`` zeros on *both* edges, then framed
  left-aligned (librosa ``center=False``) and transformed with an rFFT after
  windowing.  Frame count is ``1 + (padded_len - n_fft) // hop``.

* ``istft_noDiv`` (util.py:48-169): inverse STFT *without* the squared-window
  -sum normalization; the synthesis window is the analysis window scaled by
  ``2 / (n_fft / hop)`` (util.py:143), followed by plain overlap-add.

* ``istft_mc`` (util.py:203-226): after overlap-add, ``n_fft`` samples are
  trimmed from both ends, then the result is cut to ``nsampl``.

All functions take leading batch dims; the transforms are ``torch.fft``.
Length buckets: because framing is left-aligned and the padding is zeros,
the first ``n_frames_for_length(true_len)`` frames of a longer zero-padded
signal are the reference's frames, so a batch can share one padded length.
"""

import numpy as np
import torch

from ..utils.profiling import span
from .windows import sqrt_hann_periodic


def padded_length(nsampl: int, n_fft: int, hop: int) -> int:
    """Total length after reference-style padding (multiple-of-hop + edge pads)."""
    n_blocks = -(-nsampl // hop)  # ceil
    return n_blocks * hop + 2 * n_fft


SAMPLE_BUCKET = 32768  # ~2 s at 16 kHz


def bucket_total(nsampl: int, n_fft: int, hop: int,
                 bucket: int = SAMPLE_BUCKET) -> int:
    """padded_length rounded up to the sample-bucket grid.

    The grid is linear (1, 2, 3, 4 buckets) up to 4 buckets, then
    half-octave geometric (4, 6, 8, 12, 16, 24, ... buckets), as in the
    reference package, so both pad a signal to the same length."""
    n = -(-padded_length(nsampl, n_fft, hop) // bucket)
    if n > 4:
        # next value in {4, 6, 8, 12, 16, 24, ...}: pow2 and 1.5*pow2
        p = 4
        while p < n:
            if p + p // 2 >= n:
                p = p + p // 2
                break
            p *= 2
        n = p
    return n * bucket


def n_frames_for_length(nsampl: int, n_fft: int, hop: int) -> int:
    """Number of STFT frames the reference produces for a raw signal length."""
    total = padded_length(nsampl, n_fft, hop)
    return 1 + (total - n_fft) // hop


def stft_frames(x: torch.Tensor, window: torch.Tensor, n_fft: int,
                hop: int) -> torch.Tensor:
    """STFT of a *pre-padded* signal.  (..., total) -> (..., n_frames, n_fft//2+1).

    The caller applies reference-style padding (see :func:`pad_signal`);
    trailing samples that do not fill a frame are dropped.  Output is
    complex64, frames along the second-to-last axis.  Traced, the span
    ``dsp.stft``."""
    with span("dsp.stft"):
        frames = x.to(torch.float32).unfold(-1, n_fft, hop)
        frames = frames * window.to(torch.float32)
        return torch.fft.rfft(frames, dim=-1).to(torch.complex64)


def pad_signal(x: torch.Tensor, n_fft: int, hop: int,
               total: int | None = None) -> torch.Tensor:
    """Reference-style padding: round up to hop multiple, add n_fft both edges.

    If ``total`` is given, additionally right-pad with zeros to ``total``
    (length-bucketing; extra frames are sliced off by the caller).
    """
    nsampl = x.shape[-1]
    base = padded_length(nsampl, n_fft, hop)
    if total is None:
        total = base
    if total < base:
        raise ValueError(f"bucket length {total} < required padded length {base}")
    return torch.nn.functional.pad(x, (n_fft, total - n_fft - nsampl))


def stft(x: torch.Tensor, n_fft: int = 512, hop: int = 128,
         window: torch.Tensor | None = None) -> torch.Tensor:
    """Full reference-semantics STFT: pad + frame + window + rFFT.

    (..., nsampl) -> (..., n_frames, F) complex64 with F = n_fft//2 + 1.
    """
    if window is None:
        window = torch.as_tensor(sqrt_hann_periodic(n_fft), device=x.device)
    return stft_frames(pad_signal(x, n_fft, hop), window, n_fft, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add synthesis.  (..., n_frames, n_fft) -> (..., n_fft + hop*(n_frames-1)).

    Hop-block accumulation (n_fft//hop shifted adds) when
    ``n_fft % hop == 0``; one add per frame otherwise."""
    n_frames, n_fft = frames.shape[-2], frames.shape[-1]
    lead = frames.shape[:-2]
    out_len = n_fft + hop * (n_frames - 1)
    if n_fft % hop == 0:
        ratio = n_fft // hop
        fb = frames.reshape(*lead, n_frames, ratio, hop)
        acc = frames.new_zeros((*lead, n_frames + ratio - 1, hop))
        for k in range(ratio):
            acc[..., k : k + n_frames, :] += fb[..., k, :]
        return acc.reshape(*lead, (n_frames + ratio - 1) * hop)[..., :out_len]
    y = frames.new_zeros((*lead, out_len))
    for i in range(n_frames):
        y[..., i * hop : i * hop + n_fft] += frames[..., i, :]
    return y


def istft_frames(spec: torch.Tensor, window: torch.Tensor, n_fft: int,
                 hop: int) -> torch.Tensor:
    """Inverse STFT, no window-sum division (reference istft_noDiv semantics).

    (..., n_frames, F) -> (..., n_fft + hop*(n_frames-1)).
    The synthesis window is ``window * 2/(n_fft/hop)`` (util.py:143).
    Traced, the span ``dsp.istft``.
    """
    with span("dsp.istft"):
        scale = 2.0 / (float(n_fft) / float(hop))
        syn = window.to(torch.float32) * float(np.float32(scale))
        frames = torch.fft.irfft(spec, n=n_fft, dim=-1).to(torch.float32)
        return overlap_add(frames * syn, hop)


def istft(spec: torch.Tensor, n_fft: int = 512, hop: int = 128,
          window: torch.Tensor | None = None,
          nsampl: int | None = None) -> torch.Tensor:
    """Full reference-semantics iSTFT: irFFT + OLA + edge trim + length cut.

    Mirrors ``istft_mc(..., flag_noDiv=1)`` (util.py:203-226).
    """
    if window is None:
        window = torch.as_tensor(sqrt_hann_periodic(n_fft), device=spec.device)
    y = istft_frames(spec, window, n_fft, hop)
    y = y[..., n_fft:-n_fft] if y.shape[-1] > 2 * n_fft else y[..., :0]
    if nsampl is not None:
        y = y[..., :nsampl]
    return y
