"""Analysis/synthesis windows.

The reference system uses a *periodic* (``sym=False``) sqrt-Hann window for
both analysis and synthesis (reference: audio_dataset.py:194 builds
``np.sqrt(scipy.signal.hann(N, sym=False))``).
"""

import numpy as np


def hann_periodic(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window: 0.5 - 0.5*cos(2*pi*k/n), k = 0..n-1."""
    k = np.arange(n, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)
    return w.astype(dtype)


def sqrt_hann_periodic(n: int, dtype=np.float32) -> np.ndarray:
    """Square root of the periodic Hann window (== sin(pi*k/n)).

    Matches ``np.sqrt(scipy.signal.hann(N, sym=False))`` used by the
    reference (audio_dataset.py:194).
    """
    return np.sqrt(hann_periodic(n, dtype=np.float64)).astype(dtype)
