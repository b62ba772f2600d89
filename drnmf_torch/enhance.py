"""Batch enhancement: waveform in, enhanced waveform out.

STFT -> magnitude -> DR-NMF ratio mask -> masked complex spectrum ->
overlap-add iSTFT over a batch of equal-padded utterances, all on one device
with no host round trip in between.  On the card the recurrence runs in
kernel B1 (frozen-U model) or kernel B3 (dense-U model), by the routing rule
of ``models.drnmf`` (see ``ops.drnmf_scan``).
"""

import time

import numpy as np
import torch

from .device import params_on_device, resolve_device
from .dsp.stft import (bucket_total, istft_frames, n_frames_for_length,
                       stft_frames)
from .dsp.windows import sqrt_hann_periodic
from .models.drnmf import DRNMFConfig, drnmf_forward
from .utils.profiling import count, span


def stage_clock(stages: dict, device):
    """Returns ``lap(name)``, which adds the seconds since the previous lap
    (the first one: since this call) to ``stages[name]``.  On the card each
    reading first waits for the work queued so far, so a stage's device
    time lands in that stage."""
    device = torch.device(device)

    def now():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    last = [now()]

    def lap(name):
        t = now()
        stages[name] = stages.get(name, 0.0) + t - last[0]
        last[0] = t

    return lap


def _no_lap(name):
    pass


def make_enhancer(config: DRNMFConfig, n_fft: int = 512, hop: int = 128,
                  device="cuda", scan_fn=None, lap=None):
    """Returns ``enhance(params, wav_padded) -> wav_enhanced``.

    ``params``: name -> tensor on ``device``.  ``wav_padded``: (B, total)
    float32 on ``device``, already padded as :func:`dsp.stft.pad_signal`
    does.  The output has the same length; slice ``[n_fft:-n_fft][:nsampl]``
    per utterance to undo the edge pads (or use :func:`enhance_signals`).
    ``scan_fn`` replaces the recurrence's kernel wrapper, B1's or B3's (see
    ``models.drnmf._scan_hidden``).  ``lap`` (from :func:`stage_clock`) is
    called after the stages ``stft``, ``mask`` and ``istft``.
    """
    device = resolve_device(device)
    window = torch.as_tensor(sqrt_hann_periodic(n_fft), device=device)
    lap = lap or _no_lap

    @torch.inference_mode()
    def enhance(params, wav):
        spec = stft_frames(wav, window, n_fft, hop)  # (B, T, F) complex64
        lap("stft")
        irm = drnmf_forward(params, config, spec.abs(), scan_fn=scan_fn)
        lap("mask")
        y = istft_frames(spec * irm.to(spec.dtype), window, n_fft, hop)
        lap("istft")
        return y

    return enhance


def enhance_signals(params, config: DRNMFConfig, signals, n_fft: int = 512,
                    hop: int = 128, batch_size: int = 128, device="cuda",
                    scan_fn=None, lap=None):
    """Enhance a list of 1-D float32 signals; returns same-length numpy arrays.

    ``params``: name -> tensor or array; moved to ``device`` once.  Pads
    each batch on the host to its longest signal's sample bucket, runs
    :func:`make_enhancer`, and trims the edge pads and each signal's length.
    ``scan_fn`` and ``lap``: see :func:`make_enhancer`; ``lap`` is also
    called after the stages ``pad_and_copy_in`` (the first batch's includes
    moving ``params``) and ``copy_out_and_trim``, once per batch.

    Traced (``utils.profiling``), the call is the span ``enhance.call``
    over the spans ``enhance.pad``, ``enhance.copy_in``,
    ``enhance.copy_out`` and ``enhance.trim`` of each batch, and the
    counters ``enhance.frames_run`` (rows x the padded batch's STFT
    frames) and ``enhance.frames_signal`` (the signals' own frames) give
    the share of the recurrence's frames that is padding.
    """
    with span("enhance.call", signals=len(signals)):
        device = resolve_device(device)
        lap = lap or _no_lap
        params = params_on_device(params, device)
        enhance = make_enhancer(config, n_fft, hop, device, scan_fn, lap)
        out = []
        for start in range(0, len(signals), batch_size):
            chunk = signals[start : start + batch_size]
            with span("enhance.pad"):
                # shared sample-bucket grid (a zero tail enhances to zeros)
                total = max(bucket_total(len(s), n_fft, hop) for s in chunk)
                batch_np = np.zeros((len(chunk), total), np.float32)
                signal_frames = 0
                for row, s in enumerate(chunk):
                    x = np.asarray(s, np.float32)
                    batch_np[row, n_fft : n_fft + x.shape[-1]] = x
                    signal_frames += n_frames_for_length(x.shape[-1], n_fft,
                                                         hop)
            count("enhance.frames_run",
                  len(chunk) * (1 + (total - n_fft) // hop))
            count("enhance.frames_signal", signal_frames)
            with span("enhance.copy_in"):
                wav = torch.from_numpy(batch_np).to(device)
            lap("pad_and_copy_in")
            y = enhance(params, wav)
            with span("enhance.copy_out"):
                y = y.cpu().numpy()
            with span("enhance.trim"):
                for row, s in zip(y, chunk):
                    out.append(row[n_fft:-n_fft][: len(s)])
            lap("copy_out_and_trim")
        return out
