"""Traffic from a seed: WSJ0-like utterance lengths and synthetic noisy
speech at CHiME2's six SNRs, made on the device.

``wsj0_like_lengths`` is a frozen copy of
drnmf_torch/data/synthetic.py:76-82.  ``quantile_lengths`` draws the same
distribution as a fixed set: one length at each quantile (i + 1/2)/n, so
every seed gets the same lengths and only their order and the audio
differ, and the work of a call does not change with the seed.

``synth_pairs`` is the recipe of drnmf_torch/data/synthetic.py:30-57 and
:95-106 (harmonic-stack "vowels" with a pitch contour and a syllabic
envelope; noise filtered by 8 random decaying taps; the noise scaled to the
SNR; both divided by the noisy peak where it passes 1), done for a block
of signals at once on the device with a ``torch.Generator``: the draws
differ from numpy's, and the filter is a causal 8-tap convolution where
numpy's ``convolve(mode="same")`` centres it."""

import math

import numpy as np
import torch

from ..reference.dsp import sqrt_hann

SNR_DB = (-6, -3, 0, 3, 6, 9)  # CHiME2's six conditions


def wsj0_like_lengths(rng, n_files, min_sec=2.5, max_sec=16.0):
    """Utterance lengths (seconds) with a WSJ0-si_tr_s-like distribution:
    lognormal around ~7 s, clipped to [2.5, 16]."""
    secs = np.exp(rng.normal(np.log(7.0), 0.35, n_files))
    return np.clip(secs, min_sec, max_sec)


def quantile_lengths(n, median_s=7.0, sigma=0.35, min_s=2.5, max_s=16.0):
    """``wsj0_like_lengths``' distribution as a fixed set of ``n`` lengths
    (seconds, ascending): the lognormal's quantiles at (i + 1/2)/n."""
    q = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    secs = torch.exp(math.log(median_s) + sigma * torch.special.ndtri(q))
    return np.clip(secs.numpy(), min_s, max_s)


def synth_pairs(gen, n_samples, snr_db, fs, device):
    """Clean and noisy signals, each (n, max(n_samples)) float32 on
    ``device`` and zero past its own length.  ``n_samples``: lengths in
    samples; ``snr_db``: the SNR of each signal; ``gen``: a
    ``torch.Generator`` on ``device``."""
    n = len(n_samples)
    n_max = int(max(n_samples))
    f64 = torch.float64

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand((n, *shape), generator=gen,
                                           dtype=f64, device=device)

    lens = torch.as_tensor(np.asarray(n_samples), device=device)
    valid = torch.arange(n_max, device=device)[None, :] < lens[:, None]
    count = lens.to(f64)
    t = torch.arange(n_max, dtype=f64, device=device)[None, :] / fs

    # speech: a harmonic stack with a pitch contour and a syllabic envelope
    f0 = uniform(90, 220, 1)
    vibrato = 1.0 + 0.03 * torch.sin(2 * math.pi * uniform(2, 5, 1) * t)
    phase = 2 * math.pi * f0 * torch.cumsum(vibrato, dim=1) / fs
    amp = uniform(0.2, 1.0, 8) / torch.arange(1, 9, dtype=f64,
                                              device=device)
    offset = uniform(0, 2 * math.pi, 8)
    clean = torch.zeros((n, n_max), dtype=f64, device=device)
    for h in range(8):
        clean += amp[:, h:h + 1] * torch.sin((h + 1) * phase
                                             + offset[:, h:h + 1])
    env = 0.5 * (1 + torch.sin(2 * math.pi * uniform(2, 6, 1) * t
                               + uniform(0, 2 * math.pi, 1)))
    clean = clean * (env ** 1.5 + 0.05) * valid
    clean = 0.3 * clean / clean.abs().amax(dim=1, keepdim=True)
    del phase, vibrato, env

    # noise: white noise through 8 random decaying taps, unit power
    taps = uniform(0.2, 1.0, 8) * torch.exp(
        -torch.arange(8, dtype=f64, device=device) / uniform(1.0, 4.0, 1))
    white = torch.randn((1, n, n_max + 7), generator=gen, dtype=f64,
                        device=device)
    noise = torch.nn.functional.conv1d(white, taps.flip(1)[:, None, :],
                                       groups=n)[0] * valid
    del white
    std = torch.sqrt((noise ** 2).sum(dim=1, keepdim=True)
                     / count[:, None])
    noise = noise / (std + 1e-9)

    # the noise scaled to each SNR, both divided by the noisy peak past 1
    p_clean = (clean ** 2).sum(dim=1, keepdim=True) / count[:, None]
    p_noise = (noise ** 2).sum(dim=1, keepdim=True) / count[:, None]
    snr = torch.as_tensor(np.asarray(snr_db, np.float64),
                          device=device)[:, None]
    noise = noise * torch.sqrt(p_clean / (p_noise * 10 ** (snr / 10)))
    noisy = clean + noise
    peak = noisy.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
    return (clean / peak).float(), (noisy / peak).float()


def call_lengths(traffic, per_call, fs, seed_rng, n_calls):
    """Per call, the lengths (samples) of its signals in the seed's order
    and their SNRs: every call holds the same ``quantile_lengths`` set,
    permuted by ``seed_rng``; the SNRs cycle through the six conditions
    over each call's positions, in another permutation."""
    spec = traffic["lengths"]
    secs = quantile_lengths(per_call, spec["median_s"], spec["sigma"],
                            spec["min_s"], spec["max_s"])
    samples = (secs * fs).astype(np.int64)
    snr = np.resize(np.asarray(SNR_DB), per_call)
    out = []
    for _ in range(n_calls):
        out.append((samples[seed_rng.permutation(per_call)],
                    snr[seed_rng.permutation(per_call)]))
    return out


def dictionary(gen, f, n2r, device, power):
    """A random dictionary (F, 2r) with unit-norm columns, drawn on the
    device: each entry u ** ``power`` for u uniform in (0, 1).  A power of
    16 gives sparse nonnegative atoms (a mean cosine of about 0.12 between
    two atoms, the top eigenvalue of D^T D about 230 at 257 x 2000), under
    which ISTA with the paper's alph = 400 converges and every layer of the
    unfolded network is active; chip_smoke.py:432-449's uniform(0.01, 1)
    atoms (about 1,500) make every layer overshoot, leave layers 1 and 3
    zero at every unit, and with them most of the gradient."""
    w = torch.rand((f, n2r), generator=gen, device=device) ** power
    return w / torch.sqrt((w * w).sum(dim=0, keepdim=True))


def frames_of(n_samples, n_fft, hop):
    """STFT frames of a signal of ``n_samples`` (padded up to a multiple of
    the hop and by n_fft on both edges, left-aligned frames)."""
    return 1 + (-(-np.asarray(n_samples) // hop) * hop + n_fft) // hop


def offline_corpus(traffic, per_call, n_calls, fs, rng, gen, device):
    """``n_calls`` calls of ``per_call`` noisy signals (1-D float32 numpy
    arrays), each call the same set of lengths in its own order (see
    ``call_lengths``)."""
    corpus = []
    for lens, snr in call_lengths(traffic, per_call, fs, rng, n_calls):
        _, noisy = synth_pairs(gen, lens, snr, fs, device)
        host = noisy.cpu().numpy()
        corpus.append([host[i, :n] for i, n in enumerate(lens)])
        del noisy
    return corpus


def pick_sample(corpus, per_call, rng):
    """(call, position) pairs to check: in every call its longest signal
    and ``per_call - 1`` others drawn by ``rng``."""
    out = []
    for c, signals in enumerate(corpus):
        lens = np.array([len(s) for s in signals])
        longest = int(np.argmax(lens))
        others = [i for i in rng.permutation(len(signals)) if i != longest]
        out += [(c, int(i)) for i in [longest] + others[:per_call - 1]]
    return out


def train_split(traffic, n_fft, hop, fs, mask_value, rng, gen, device,
                block=256):
    """One epoch of training sequences, made on the device: WSJ0-like
    utterances (``quantile_lengths``, enough of them to fill the epoch, in
    the seed's order, SNRs cycling over the six conditions) as noisy and
    clean magnitude spectrograms, cut into ``maxlen``-frame sequences; an
    utterance's last sequence holds ``mask_value`` past its end, with mask
    0, as the featurizer pads it.  Returns (x, y, mask (n, T, 1)) on
    ``device`` and the valid frames of each sequence (numpy)."""
    t_len = int(traffic["maxlen"])
    n_seq = int(traffic["batch"]) * int(traffic["batches_per_epoch"])
    spec = traffic["lengths"]
    f = n_fft // 2 + 1
    n_utt = n_seq // 2
    while True:
        secs = quantile_lengths(n_utt, spec["median_s"], spec["sigma"],
                                spec["min_s"], spec["max_s"])
        samples = (secs * fs).astype(np.int64)
        chunks = -(-frames_of(samples, n_fft, hop) // t_len)
        if chunks.sum() >= n_seq:
            break
        n_utt += max(1, (n_seq - int(chunks.sum())) // 2)
    order = rng.permutation(n_utt)
    samples = samples[order]
    snr = np.resize(np.asarray(SNR_DB), n_utt)[rng.permutation(n_utt)]

    x = torch.full((n_seq, t_len, f), mask_value, device=device)
    y = torch.full((n_seq, t_len, f), mask_value, device=device)
    mask = torch.zeros((n_seq, t_len, 1), device=device)
    window = sqrt_hann(n_fft, device)
    at = 0
    for b0 in range(0, n_utt, block):
        if at >= n_seq:
            break
        lens = samples[b0:b0 + block]
        clean, noisy = synth_pairs(gen, lens, snr[b0:b0 + block], fs, device)
        n_max = clean.shape[1]
        total = -(-n_max // hop) * hop + 2 * n_fft
        frames = torch.as_tensor(frames_of(lens, n_fft, hop), device=device)
        t_pad = -(-int(frames.max()) // t_len) * t_len
        t_idx = torch.arange(t_pad, device=device)
        keep = (t_idx[None, :] < frames[:, None])  # (b, t_pad)
        n_chunks = -(-frames // t_len)
        real = (torch.arange(t_pad // t_len, device=device)[None, :]
                < n_chunks[:, None])  # (b, chunks)
        for dst, sig in ((x, noisy), (y, clean)):
            padded = torch.nn.functional.pad(sig, (n_fft,
                                                   total - n_fft - n_max))
            mag = torch.fft.rfft(padded.unfold(-1, n_fft, hop) * window,
                                 dim=-1).abs()
            mag = torch.nn.functional.pad(mag, (0, 0, 0,
                                                t_pad - mag.shape[1]))
            mag = torch.where(keep[..., None], mag, mask_value)
            seqs = mag.view(len(lens), t_pad // t_len, t_len, f)[real]
            take = min(len(seqs), n_seq - at)
            dst[at:at + take] = seqs[:take]
            del padded, mag, seqs
        seq_mask = keep.view(len(lens), t_pad // t_len, t_len)[real]
        mask[at:at + take, :, 0] = seq_mask[:take].float()
        at += take
        del clean, noisy
    valid = mask[..., 0].sum(dim=1).cpu().numpy()
    return x, y, mask, valid
