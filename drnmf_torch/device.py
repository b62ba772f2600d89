"""The one place that sets up the device for the port's entry points."""

import torch


def resolve_device(device="cuda") -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.

    Raises when CUDA was asked for (the default) and is absent, instead of
    running on the CPU quietly.  On CUDA, turns TF32 off for matmuls and
    cuDNN: the reference runs in full float32, and TF32 keeps only about
    three decimal digits, which would break parity with it."""
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
