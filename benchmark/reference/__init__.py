"""The plain reference: DR-NMF and sparse-NMF enhancement and DR-NMF
training written from the published equations in plain PyTorch, float32
with TF32 off, dense matrices and time loops.  It imports nothing of the
program and builds its own parameters from the benchmark's dictionary and
the configuration.  ``precision="tf32"`` computes every product with its
operands rounded to TF32 (the control, see ``mm``)."""
