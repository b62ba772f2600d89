"""Products of the reference in the precision it is asked for."""

import torch


def tf32_round(x):
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties to even: what the tensor cores multiply in a TF32 product."""
    bits = x.detach().contiguous().view(torch.int32)
    low = torch.bitwise_and(torch.bitwise_right_shift(bits, 13), 1)
    rounded = torch.bitwise_and(bits + 0x0FFF + low, ~0x1FFF)
    return rounded.view(torch.float32)


def _flat_mm(a, b):
    """a (..., k) @ b (k, n) through one 2-D product."""
    out = a.reshape(-1, a.shape[-1]) @ b
    return out.reshape(*a.shape[:-1], b.shape[-1])


class _TF32MM(torch.autograd.Function):
    """a @ b with TF32 operands and float32 sums, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _flat_mm(tf32_round(a), tf32_round(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g2 = tf32_round(g.reshape(-1, g.shape[-1]))
        a2 = tf32_round(a.reshape(-1, a.shape[-1]))
        grad_a = (g2 @ tf32_round(b).T).reshape(a.shape)
        grad_b = a2.T @ g2
        return grad_a, grad_b


def mm(a, b, precision="f32"):
    """``a @ b`` (``b`` 2-D) in float32 with TF32 off; ``precision="tf32"``
    rounds the operands of every product, forward and backward, to TF32
    and sums in float32, as a TF32 tensor-core product does (the control:
    the nearest precision below float32)."""
    if precision == "tf32":
        return _TF32MM.apply(a, b)
    if precision != "f32":
        raise ValueError(f"unknown precision {precision}")
    return a @ b


def no_tf32():
    """Turn TF32 off for PyTorch's own products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
