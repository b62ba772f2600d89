"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit).  Frozen copy of
chip_smoke.py:291-292."""

PEAK_TF32_FLOPS = 495e12  # dense TF32 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3
