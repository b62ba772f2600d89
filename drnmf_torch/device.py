"""The one place that sets up the device for the port's entry points."""

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.

    Raises when CUDA was asked for (the default) and is absent, instead of
    running on the CPU quietly.  On CUDA, turns TF32 off for matmuls and
    cuDNN: the tests hold the port against the reference at
    ``matmul_precision='highest'`` (full float32), and a single TF32
    product keeps only about three decimal digits, which would break that
    parity.  (The reference's own default is looser in places: its TPU MU
    kernels take bf16 product inputs unless told otherwise.  The port's MU
    kernels use TF32 only in the error-compensated three-product form,
    which keeps f32-class accuracy.)"""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def params_on_device(params: dict, device) -> dict:
    """name -> tensor or array -> name -> float32 tensor on ``device`` (a
    tensor already there is passed through, not copied)."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v, np.float32)))
            .to(device, torch.float32) for k, v in params.items()}
