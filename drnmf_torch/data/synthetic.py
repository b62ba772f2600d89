"""Synthetic mini-corpus generator (counterpart of
``drnmf_tpu/data/synthetic.py``: numpy and wav writes only, so the same
seed and lengths write the same wav bytes in both packages).

The reference evaluates on CHiME2 WSJ0 (LDC-licensed, not redistributable),
so tests and benches here use a generated corpus with the same directory
shape: paired 'scaled' (noisy) and clean wavs bucketed by SNR directory
({m6dB,m3dB,0dB,3dB,6dB,9dB}), so that the 'scaled'->'enhanced_<desc>' path
substitution and per-SNR score filtering (audio_dataset.py:399-435) exercise
identical code paths.

Clean signals are harmonic-stack "vowels" with time-varying envelopes and
pitch; noise is filtered Gaussian noise -- enough spectral structure for NMF
dictionaries to separate.
"""

import os

import numpy as np

from ..dsp.wav import wavwrite

SNR_DIRS = ("m6dB", "m3dB", "0dB", "3dB", "6dB", "9dB")
_SNR_DB = {"m6dB": -6, "m3dB": -3, "0dB": 0, "3dB": 3, "6dB": 6, "9dB": 9}


def _synthetic_speech(rng, n, fs):
    """Harmonic stack with random pitch contour + syllabic envelope."""
    t = np.arange(n) / fs
    f0 = rng.uniform(90, 220)
    vibrato = 1.0 + 0.03 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
    phase = 2 * np.pi * f0 * np.cumsum(vibrato) / fs
    sig = np.zeros(n)
    for h in range(1, 9):
        amp = rng.uniform(0.2, 1.0) / h
        sig += amp * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
    # syllabic (2-6 Hz) envelope
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 6) * t + rng.uniform(0, 2 * np.pi)))
    env = env ** 1.5 + 0.05
    sig = sig * env
    return (0.3 * sig / np.max(np.abs(sig))).astype(np.float32)


def _synthetic_noise(rng, n, fs):
    """Spectrally-shaped noise (lowpass-ish random filter)."""
    white = rng.standard_normal(n + 64)
    taps = rng.uniform(0.2, 1.0, 8) * np.exp(-np.arange(8) / rng.uniform(1.0, 4.0))
    shaped = np.convolve(white, taps, mode="same")[:n]
    return (shaped / (np.std(shaped) + 1e-9)).astype(np.float32)


def wsj0_like_lengths(rng, n_files, min_sec=2.5, max_sec=16.0):
    """Utterance lengths (seconds) with a WSJ0-si_tr_s-like distribution:
    read sentences, lognormal around ~7 s, clipped to [2.5, 16] -- used by
    the full-scale shakeout so the length-bucketed featurizer and maxlen
    chunker see a realistic mix, not uniform lengths."""
    secs = np.exp(rng.normal(np.log(7.0), 0.35, n_files))
    return np.clip(secs, min_sec, max_sec)


def make_synthetic_corpus(root, n_files=12, fs=16000, seed=2016,
                          min_sec=0.6, max_sec=2.0, lengths=None,
                          verbose_every=0):
    """Create wavs + taskfiles.  Returns dict of taskfile paths.

    ``lengths``: optional per-file durations in seconds (overrides the
    uniform [min_sec, max_sec] draw) -- see :func:`wsj0_like_lengths`."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    noisy_list, clean_list = [], []
    for i in range(n_files):
        if verbose_every and i % verbose_every == 0:
            print(f"  [corpus] {i}/{n_files}", flush=True)
        snr_dir = SNR_DIRS[i % len(SNR_DIRS)]
        snr_db = _SNR_DB[snr_dir]
        n = int(fs * (lengths[i] if lengths is not None
                      else rng.uniform(min_sec, max_sec)))
        clean = _synthetic_speech(rng, n, fs)
        noise = _synthetic_noise(rng, n, fs)
        # scale noise for the target SNR
        p_clean = np.mean(clean**2)
        p_noise = np.mean(noise**2)
        noise = noise * np.sqrt(p_clean / (p_noise * 10 ** (snr_db / 10)))
        noisy = clean + noise
        peak = max(np.max(np.abs(noisy)), 1.0)
        noisy, clean = noisy / peak, clean / peak

        clean_path = os.path.join(root, "clean", "scaled", snr_dir, f"utt{i:03d}.wav")
        noisy_path = os.path.join(root, "noisy", "scaled", snr_dir, f"utt{i:03d}.wav")
        os.makedirs(os.path.dirname(clean_path), exist_ok=True)
        os.makedirs(os.path.dirname(noisy_path), exist_ok=True)
        wavwrite(clean_path, fs, clean[None, :])
        wavwrite(noisy_path, fs, noisy[None, :])
        clean_list.append(clean_path)
        noisy_list.append(noisy_path)

    taskfiles = {}
    for name, files in (("noisy", noisy_list), ("clean", clean_list)):
        path = os.path.join(root, f"taskfile_{name}.txt")
        with open(path, "w") as f:
            f.write("\n".join(files) + "\n")
        taskfiles[name] = path
    return taskfiles
