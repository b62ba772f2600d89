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
    parity.  That covers PyTorch's own products: the heads, the glue, the
    plain versions and training's weight-gradient products.  The
    hand-written kernels fix their own arithmetic, whatever
    ``DRNMFConfig.matmul_precision`` says: B2, B3 and the MU kernels B4/B5
    use TF32 only in the error-compensated three-pass form, which keeps
    f32-class accuracy; B1 and its backward kernel run f32 on the CUDA
    cores.  (The reference's own default is looser in places: its TPU MU
    kernels take bf16 product inputs unless told otherwise.)"""
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


def free_bytes(device) -> int:
    """Bytes a new allocation on ``device`` can take: the card's free memory
    plus what PyTorch's caching allocator holds unused.  Unbounded on the
    CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1 << 62
    free, _ = torch.cuda.mem_get_info(device)
    return free + (torch.cuda.memory_reserved(device)
                   - torch.cuda.memory_allocated(device))
