"""drnmf_torch: the DR-NMF speech enhancer in PyTorch, with hand-written
CUDA kernels for an NVIDIA Hopper card (sm_90a).

A port of ``drnmf_tpu`` (JAX on a TPU), which stays beside it as the
reference.  Module names mirror the JAX package so each counterpart is easy
to find:

- ``dsp``      -- STFT / iSTFT, windows, wav I/O
- ``models``   -- the DR-NMF unfolded-ISTA model (inference side)
- ``ops``      -- the hand-written CUDA kernels and their plain versions
- ``train``    -- ``.npz`` checkpoints
- ``enhance``  -- the batch enhancer (waveform in, enhanced waveform out)
- ``convert``  -- parameters across from the JAX package, and init
- ``config``   -- YAML model config -> ``DRNMFConfig``
- ``enhance_wav`` -- command line: config + checkpoint + wavs -> wavs

This package never imports ``jax`` or ``drnmf_tpu``; importing it sets no
process-global torch state.
"""

__version__ = "0.1.0"
