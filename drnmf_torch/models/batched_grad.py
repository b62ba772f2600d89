"""The training recurrence: the folded + factored scan with a batched-T
backward (counterpart of ``drnmf_tpu/models/batched_grad.py``).

``scan_factored_train`` has the semantics of the JAX package's
``scan_plain_batched`` on the operands of ``ops.drnmf_scan.
drnmf_scan_factored``: the same forward, and a backward split in two.

- The forward is B1 with every layer kept (``keep_layers=True``): the top
  output (B, T, 2r) and the layer stack h_all (K, 2r, T, Bp).
- The backward runs the sequential part, the reverse delta chain
  (``back_step``), in one kernel (``drnmf_scan_factored_backward``), which
  also returns the gradient of h0 and each later layer's ``p = d_k @
  dka_k^T``.  Then every weight gradient is one product contracting over
  T·Bp (``_bwd`` :123-149), in ``torch.matmul``, on the layouts the kernels
  write:

      d_dka_0 = x^T d_0;   for k >= 1:  d_dka_k = r_k^T d_k,
      d_dkT_{k-1} = -(p_k^T h_{k-1})^T,   r_k = x - h_{k-1} dkT_{k-1};
      d_b_k = sum d_k;     d_x = d_0 dka_0^T + sum_k p_k (when x needs it).

The folded U fields (diag1, off1, c) are detached by the model, as the JAX
package stops their gradient, so they get none here.  Autograd carries the
rest to log_D, log_alph, log_lam1 and log_h0 through the effective
matrices.  On CPU tensors both kernels' wrappers run their plain versions;
``scan_factored_train_reference`` runs the plain versions on any device.

The residuals (the layer stack and, in the backward, the deltas) take
``batched_grad_residual_bytes``: 1.28 GB at B=32, T=500, 2r=2000, K=5.
The forward raises when they do not fit the card's free memory less
``RESIDUAL_MARGIN_BYTES``, naming the sizes, instead of falling back.
"""

import torch

from ..device import free_bytes
from ..ops.drnmf_scan import (drnmf_scan_factored,
                              drnmf_scan_factored_backward,
                              drnmf_scan_factored_backward_reference,
                              drnmf_scan_factored_reference)

# room kept free past the residuals: the weight-gradient products'
# operands (r_k and x batch-innermost, (F, T·Bp) each: 16 MB at the
# flagship schedule), the heads' and the loss's activations and gradients
# ((B, T, F) and (B, T, 2r) tensors: 0.1-0.3 GB there) and the backward
# kernel's g (B, T, 2r)
RESIDUAL_MARGIN_BYTES = 2 << 30


def batched_grad_residual_bytes(bsz: int, t_len: int, hidden_dim: int,
                                k_layers: int) -> int:
    """The (T, K, B, 2r) hidden and delta stacks the batched backward holds
    (f32)."""
    return 2 * 4 * bsz * t_len * hidden_dim * k_layers


def residual_budget(device) -> int:
    """Bytes the residuals may take on ``device``: its free memory less
    ``RESIDUAL_MARGIN_BYTES`` (unbounded on the CPU)."""
    return free_bytes(device) - RESIDUAL_MARGIN_BYTES


def check_residual_budget(bsz, t_len, hidden_dim, k_layers, device):
    need = batched_grad_residual_bytes(bsz, t_len, hidden_dim, k_layers)
    budget = residual_budget(device)
    if need > budget:
        raise RuntimeError(
            f"training the recurrence keeps {need} bytes of layer and delta "
            f"stacks (B={bsz}, T={t_len}, 2r={hidden_dim}, K={k_layers}); "
            f"{device} has {budget} bytes free past a margin of "
            f"{RESIDUAL_MARGIN_BYTES}: cut the batch size or maxlen")


def _weight_grads(ctx, x, h_all, delta, p_all, dkt_stack, dka_stack):
    """d_x, d_dkt, d_dka, d_b from the kernels' outputs, each one product
    over T·Bp (the padded columns hold zero deltas and p)."""
    k_layers, n2r, t_len, bp = h_all.shape
    bsz, _, f = x.shape
    tbp = t_len * bp
    xf = x.new_zeros((f, t_len, bp))
    xf[:, :, :bsz] = x.permute(2, 1, 0)
    xf = xf.reshape(f, tbp)
    d = delta.reshape(k_layers, n2r, tbp)
    h = h_all.reshape(k_layers, n2r, tbp)
    p = p_all.reshape(k_layers - 1, f, tbp)
    d_dka = torch.empty_like(dka_stack)
    torch.matmul(xf, d[0].T, out=d_dka[0])
    d_dkt = torch.empty_like(dkt_stack) if k_layers > 1 else None
    for k in range(1, k_layers):
        r_k = torch.addmm(xf, dkt_stack[k - 1].T, h[k - 1], alpha=-1.0)
        torch.matmul(r_k, d[k].T, out=d_dka[k])
        torch.matmul(h[k - 1], p[k - 1].T, out=d_dkt[k - 1])
        d_dkt[k - 1].neg_()
    d_b = d.sum(dim=2)
    d_x = None
    if ctx.needs_input_grad[1]:
        dxf = (dka_stack[0] @ d[0] + p.sum(dim=0)).reshape(f, t_len, bp)
        d_x = dxf[:, :, :bsz].permute(2, 1, 0).contiguous()
    return d_x, d_dkt, d_dka, d_b


class _ScanFactoredTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plain, x, step_mask, h0, diag1, off1, c_uk, dkt_stack,
                dka_stack, b_stack):
        bsz, t_len, _ = x.shape
        check_residual_budget(bsz, t_len, h0.shape[-1], dka_stack.shape[0],
                              x.device)
        scan = drnmf_scan_factored_reference if plain else drnmf_scan_factored
        out, h_all = scan(x, step_mask, h0, diag1, off1, c_uk, dkt_stack,
                          dka_stack, b_stack, keep_layers=True)
        ctx.plain = plain
        ctx.save_for_backward(x, step_mask, h_all, diag1, off1, c_uk,
                              dkt_stack, dka_stack)
        return out

    @staticmethod
    def backward(ctx, g):
        x, step_mask, h_all, diag1, off1, c_uk, dkt, dka = ctx.saved_tensors
        back = (drnmf_scan_factored_backward_reference if ctx.plain
                else drnmf_scan_factored_backward)
        delta, p_all, gamma = back(g.contiguous(), step_mask, h_all, diag1,
                                   off1, c_uk, dkt, dka)
        d_x, d_dkt, d_dka, d_b = _weight_grads(ctx, x, h_all, delta, p_all,
                                               dkt, dka)
        return (None, d_x, None, gamma, None, None, None, d_dkt, d_dka, d_b)


def scan_factored_train(x, step_mask, h0, diag1, off1, c_uk, dkt_stack,
                        dka_stack, b_stack):
    """``drnmf_scan_factored``'s function with the batched-T backward: on
    the card B1 with every layer kept, then the backward kernel and the
    weight-gradient products.  Arguments and result as for
    ``drnmf_scan_factored``."""
    return _ScanFactoredTrain.apply(False, x, step_mask, h0, diag1, off1,
                                    c_uk, dkt_stack, dka_stack, b_stack)


def scan_factored_train_reference(x, step_mask, h0, diag1, off1, c_uk,
                                  dkt_stack, dka_stack, b_stack):
    """``scan_factored_train`` on the plain versions of both kernels, on any
    device: the forward's plain loop with the layer stack, then
    ``back_step`` in PyTorch, then the same weight-gradient products."""
    return _ScanFactoredTrain.apply(True, x, step_mask, h0, diag1, off1,
                                    c_uk, dkt_stack, dka_stack, b_stack)
