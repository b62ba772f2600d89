"""PESQ (ITU-T P.862) MOS estimation, 16 kHz mode (counterpart of
``drnmf_tpu/metrics/pesq.py``).

Replaces the reference's ``pesq_16kHz`` MATLAB call (score_audio.m:225),
which the reference computed by default on every scored file.  PESQ is
likewise computed by default here; ``compute=False`` (CLI ``--no-pesq``)
gives -1.0.  The model (``_pesq_model``) is the repo's P.862-structured
model for time-aligned signals, calibrated on published speech + white
noise anchors; it is not bit-identical to the ITU reference binaries.
"""

import numpy as np


def pesq_16k(ref, est, fs: int = 16000, compute: bool = True) -> float:
    if not compute:
        return -1.0
    from ._pesq_model import pesq_mos_aligned

    return pesq_mos_aligned(np.asarray(ref, np.float64).ravel(),
                            np.asarray(est, np.float64).ravel(), fs)
