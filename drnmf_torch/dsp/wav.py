"""16-bit PCM wav I/O with the reference's scaling conventions.

Reference parity (util.py:29-45): reads int16 PCM and scales by 1/32768 to
float32 of shape (nch, nsampl); writes float32 by peak-normalizing if the
peak exceeds 1.0 and scaling by 32767 to int16.
"""

import numpy as np
import scipy.io.wavfile


def wavread_fs(wavfile):
    """Read a wav file -> ((nch, nsampl) float32 scaled by 1/32768, fs)."""
    if isinstance(wavfile, list):
        wavfile = wavfile[0]
    fs, x = scipy.io.wavfile.read(wavfile)  # (nsampl,) or (nsampl, nch)
    if x.ndim == 1:
        x = x[:, None]
    x = x.T.astype(np.float32) / np.float32(32768.0)
    return x, fs


def wavread(wavfile):
    """Read a wav file -> (nch, nsampl) float32 scaled by 1/32768."""
    return wavread_fs(wavfile)[0]


def wavwrite(wavfile, fs, x):
    """Write (nch, nsampl) or (nsampl,) float32 audio as int16 PCM.

    Peak-normalizes if |x| exceeds 1.0 (reference util.py:37-45).
    """
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[None, :]
    if x.dtype == np.float32 or x.dtype == np.float64:
        peak = np.max(np.abs(x)) if x.size else 0.0
        if peak > 1.0:
            x = x / peak
        x = np.int16(x * 32767.0)
    scipy.io.wavfile.write(wavfile, int(fs), x.T)
