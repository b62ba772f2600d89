"""drnmf_torch: the DR-NMF speech enhancer in PyTorch, with hand-written
CUDA kernels for an NVIDIA Hopper card (sm_90a).

A port of ``drnmf_tpu`` (JAX on a TPU), which stays beside it as the
reference.  Module names mirror the JAX package so each counterpart is easy
to find:

- ``dsp``      -- STFT / iSTFT, windows, wav I/O, the hop-phase features
                  (``dsp.phase``)
- ``data``     -- the wav corpus -> STFT stacks -> padded tensors
                  (``AudioDataset``), the native wav reader, the synthetic
                  corpus
- ``models``   -- the DR-NMF unfolded-ISTA model, the LSTM baseline and the
                  SNMF enhancer
- ``ops``      -- the hand-written CUDA kernels and their plain versions;
                  sparse NMF (``ops.snmf``); ISTA (``ops.ista``)
- ``train``    -- the training loop (Keras-style Adam, elastic resume),
                  losses, ``.npz`` and sharded checkpoints, the two-stage
                  SNMF dictionary recipe
- ``metrics``  -- SDR, SNR, SegSNR, PESQ and STOI with the delay guard,
                  batched on the device (``metrics.engine``), and the
                  cached scoring of taskfiles
- ``utils``    -- the hash-keyed SNMF dictionary cache; ``StageTimer``,
                  ``trace``; ``memplan`` (a fit's bytes a rank); the
                  Keras HDF5 weight import (``utils.convert``)
- ``parallel`` -- multi-rank runs on ``torch.distributed``: the process
                  group and layouts (dp, tp, FSDP), sharded sparse NMF,
                  the tensor-parallel, sequence- and layer-pipelined
                  recurrences
- ``pipeline`` -- the experiment: data, dictionary, fit, masks, wavs,
                  scores
- ``reporting`` -- score tables and learning curves from an experiment
- ``enhance``  -- the batch enhancer (waveform in, enhanced waveform out)
- ``streaming`` -- the online enhancers (``StreamingEnhancer``,
                  ``MultiStreamEnhancer``) and the paced-load harness
- ``convert``  -- parameters across from the JAX package, and init
- ``config``   -- YAML model config -> ``DRNMFConfig`` / ``SNMFParams``;
                  the artifact hash; YAML I/O and the experiment folders
- ``cli``      -- command line: an experiment from a model and a data YAML
                  (also ``python -m drnmf_torch``)
- ``enhance_wav`` -- command line: config + checkpoint + wavs -> wavs
- ``serve``    -- command line: the online enhancement server over TCP
- ``score_audio`` -- command line: score enhanced against reference wavs
- ``run_waspaa2017``, ``print_scores``, ``plot_learning_curves``,
  ``create_taskfiles``, ``import_reference_weights`` -- the experiment
                  scripts of the JAX package's ``scripts/``, each as
                  ``python -m drnmf_torch.<name>``

This package never imports ``jax`` or ``drnmf_tpu``; importing it sets no
process-global torch state.
"""

__version__ = "0.1.0"

from .streaming import MultiStreamEnhancer, StreamingEnhancer  # noqa: E402

__all__ = ["MultiStreamEnhancer", "StreamingEnhancer", "__version__"]
