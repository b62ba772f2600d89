"""Tensor-parallel DR-NMF recurrence: the 2r axis split over the ranks of
a ``tp`` group (counterpart of ``drnmf_tpu/parallel/tensor_parallel.py``).

Rank ``p`` of ``P`` owns the block ``seg = [p*2r/P, (p+1)*2r/P)`` of the
hidden axis:

* Frozen U folded (every shipped config): the (2r, 2r) U tensors never
  reach a rank; only diag(U1) and two scalars do, and the U terms are
  row sums of the carried state, which every rank holds whole.  Dense U:
  a rank reads only its rows of ``log_U1``/``log_Uk`` (inference: sliced
  on the host before they reach the device).
* S_k = I - Dhat_k^T (Dhat_k/alph_k) is applied through its two (F, 2r)
  factors, built on every rank from the replicated dictionary; it is
  never materialised, whole or in blocks.

``drnmf_scan_tp`` (inference, no gradients) computes each layer's
(B, 2r/P) block of the hidden state and gathers the blocks over ``tp``:
K gathers a step.  ``drnmf_scan_tp_train`` (differentiable) splits the
contractions over 2r instead: each rank multiplies its block of the
hidden state (and, dense, of the carry) by its block of the weights, one
sum over ``tp`` a layer completes them, and the rest of the layer runs
whole on every rank.  With S factored the sum is the (B, F) product
``hidden @ Dhat_k^T`` (dense U adds the (B, 2r) U term to the same
collective), where the JAX package's psum is (B, 2r).

So the training scan splits one of a layer's two (B, F, 2r) contractions
and the bytes of its collective, not the work or the memory as a whole:
every rank still computes ``(x_t - q) @ (Dhat_k/alph_k)`` in full and
holds the whole dictionary (K (F, 2r) pairs, 2 MB each at the flagship).
Owning a (B, 2r/P) block of each layer instead, as the inference scan
does, would halve the rest, but it needs a (B, 2r) gather a layer beside
the (B, F) sum: two collectives a layer where this takes one.  With the
ranks sharing one card and gloo staging every collective through host
memory, the collectives are most of a tp step (``PERF.md`` section 5),
so the layout with fewer of them was chosen.

Gradients across the group, Megatron's pair of autograd functions: a value
every rank holds whole enters a rank's own block through :class:`_ToTP`
(identity forward, gradients summed over ``tp`` backward), and the block
sums leave through :class:`_FromTP` (summed forward, identity backward).
Every other computation runs whole and identically on every rank, so each
parameter's gradient comes out whole and equal on every rank of the group,
and nothing is summed over ``tp`` afterwards (the JAX package's
``shard_map`` transposes do the same).  A ``dp`` axis is left to the
training loop.

Plain PyTorch: no TPU kernel stands behind this path (the JAX package runs
it as XLA per shard); a Python time loop with K collectives a step.
"""

import torch

from .mesh import Mesh


class _ToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the group ``axis``."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce(g.contiguous(), axis=ctx.axis)[0], None, None


class _FromTP(torch.autograd.Function):
    """Summed over the group ``axis`` forward; identity backward."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh.reduce(t.contiguous(), axis=axis)[0]

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _validate(config, n_tp):
    if config.hidden_dim % n_tp:
        raise ValueError(
            f"hidden_dim={config.hidden_dim} not divisible by tp={n_tp}")
    if config.return_all_hidden or config.dropout_W or config.dropout_U:
        raise NotImplementedError("tp scan supports the plain cell only")


def _dictionary(params, config, device):
    """Per layer: Dhat_k (F, 2r), Dhat_k/alph_k (F, 2r) and b_k (2r,), in
    the model's arithmetic (``models.drnmf._effective_matrices``)."""
    from ..device import params_on_device

    names = [config.untied_names(b) for b in ("log_D", "log_alph",
                                               "log_lam1")]
    need = sorted({n for group in names for n in group})
    p = params_on_device({k: params[k] for k in need}, device)
    dk, dka, b = [], [], []
    for k in range(config.K_layers):
        d = torch.exp(p[names[0][k]])
        dh = d / torch.sqrt(torch.sum(d * d, dim=0, keepdim=True))
        alph = torch.exp(p[names[1][k]])
        dk.append(dh)
        dka.append(dh / alph)
        b.append(-torch.ones((config.hidden_dim,), dtype=dh.dtype,
                             device=device)
                 * torch.exp(p[names[2][k]]) / alph)
    return dk, dka, b


def _folded_u(params, device):
    """diag(U1), U1's off-diagonal and Uk's constant, detached (the fold
    holds only for a frozen U)."""
    from ..device import params_on_device

    lu1, luk = params["log_U1"], params["log_Uk"]
    if not isinstance(lu1, torch.Tensor):  # only what the fold reads
        lu1 = {"d": lu1.diagonal().copy(), "o": lu1[0, 1:2].copy(),
               "c": luk[0, 0:1].copy()}
        t = params_on_device(lu1, device)
        return torch.exp(t["d"]), torch.exp(t["o"][0]), torch.exp(t["c"][0])
    return (torch.exp(torch.diagonal(lu1)).detach().to(device),
            torch.exp(lu1[0, 1]).detach().to(device),
            torch.exp(luk[0, 0]).detach().to(device))


def drnmf_scan_tp(params, config, x, step_mask, mesh: Mesh, axis="tp"):
    """Hidden states (B, T, 2r) with the 2r axis split over ``axis``: each
    layer's block computed on its rank and gathered (inference; no
    gradients).  x: (B, T, F) and step_mask (B, T) on the rank's device,
    the same on every rank of the group; ``params``: name -> array or
    tensor.  Equal to the single-process scan up to summation order."""
    from ..device import params_on_device
    from ..models.drnmf import _ACTIVATIONS, _h0, u_is_foldable

    n_tp = mesh.size(axis)
    _validate(config, n_tp)
    device = x.device
    n2r, K = config.hidden_dim, config.K_layers
    blk = n2r // n_tp
    seg = slice(mesh.index(axis) * blk, (mesh.index(axis) + 1) * blk)
    act = _ACTIVATIONS[config.activation]
    folded = u_is_foldable(config)
    with torch.no_grad():
        dk, dka, b = _dictionary(params, config, device)
        dka_seg = [w[:, seg] for w in dka]
        b_seg = [v[seg] for v in b]
        h0_name = "log_h0" if config.nonnegative else "h0"
        h0 = _h0(params_on_device({h0_name: params[h0_name]}, device),
                 config)
        if folded:
            diag1, off1, c = _folded_u(params, device)
            diag_seg = diag1[seg]
        else:
            # this rank's rows of log_U1/log_Uk only: U_k[:, seg] is
            # exp(log_U[seg, :])^T
            rows = params_on_device({k: params[k][seg] for k in
                                     ("log_U1", "log_Uk")}, device)
            u_cols = [torch.exp(rows["log_U1"]).T,
                      torch.exp(rows["log_Uk"]).T]
        h = h0[None, :].expand(x.shape[0], n2r)
        outs = []
        for t in range(x.shape[1]):
            x_t = x[:, t]
            if folded:
                rs = h.sum(dim=-1, keepdim=True)
            hidden = None
            for k in range(K):
                if folded:
                    u = (h[:, seg] * (diag_seg - off1) + off1 * rs if k == 0
                         else c * rs)
                else:
                    u = h @ u_cols[min(k, 1)]
                pre = u
                if k > 0:
                    q = hidden @ dk[k].T
                    pre = pre + hidden[:, seg] + (
                        (x_t - q) @ dka_seg[k]
                        if config.connect_input_to_layers
                        else -(q @ dka_seg[k]))
                elif config.connect_input_to_layers:
                    pre = pre + x_t @ dka_seg[0]
                hidden = mesh.gather(act(pre + b_seg[k]), axis, dim=1)
            h = torch.where(step_mask[:, t, None], hidden, h)
            outs.append(h)
        if not outs:
            return x.new_empty((x.shape[0], 0, n2r))
        return torch.stack(outs, dim=1)


def drnmf_scan_tp_train(params, config, x, step_mask, mesh: Mesh,
                        axis="tp"):
    """The differentiable tensor-parallel recurrence (module docstring):
    (B, T, 2r) hidden states, whole on every rank of ``axis``, from
    ``params`` (name -> tensor on the rank's device, the same on every
    rank; gradients flow to them, whole and equal on every rank of
    ``axis``).  Only ``hidden @ Dhat_k^T`` (and dense U's term) is split
    over ``axis``; the rest of each layer runs whole on every rank."""
    from ..models.drnmf import _ACTIVATIONS, _h0, u_is_foldable

    n_tp = mesh.size(axis)
    _validate(config, n_tp)
    n2r, K, F = config.hidden_dim, config.K_layers, config.input_dim
    blk = n2r // n_tp
    seg = slice(mesh.index(axis) * blk, (mesh.index(axis) + 1) * blk)
    act = _ACTIVATIONS[config.activation]
    folded = u_is_foldable(config)
    dk, dka, b = _dictionary(params, config, x.device)
    # a rank multiplies its block of 2r: Dhat_k[:, seg]
    dk_seg = [_ToTP.apply(d, mesh, axis)[:, seg] for d in dk]
    h0 = _h0(params, config)
    if folded:
        diag1, off1, c = _folded_u(params, x.device)
    else:
        # rows seg of U_k = exp(log_U)^T are exp(log_U[:, seg])^T
        u_rows = [torch.exp(_ToTP.apply(params[k], mesh, axis)[:, seg]).T
                  for k in ("log_U1", "log_Uk")]
    h = h0[None, :].expand(x.shape[0], n2r)
    outs = []
    for t in range(x.shape[1]):
        x_t = x[:, t]
        if folded:
            rs = h.sum(dim=-1, keepdim=True)
            u_first = h * (diag1 - off1) + off1 * rs
            u_rest = c * rs
        else:
            h_seg = _ToTP.apply(h, mesh, axis)[:, seg]
        hidden = None
        for k in range(K):
            parts = []
            if not folded:
                parts.append(h_seg @ u_rows[min(k, 1)])
            if k > 0:
                parts.append(_ToTP.apply(hidden, mesh, axis)[:, seg]
                             @ dk_seg[k].T)
            summed = (_FromTP.apply(torch.cat(parts, dim=1), mesh, axis)
                      if parts else None)
            if folded:
                pre = u_first if k == 0 else u_rest
            else:
                pre = summed[:, :n2r]
            if k > 0:
                q = summed[:, -F:]
                pre = pre + hidden + (
                    (x_t - q) @ dka[k] if config.connect_input_to_layers
                    else -(q @ dka[k]))
            elif config.connect_input_to_layers:
                pre = pre + x_t @ dka[0]
            hidden = act(pre + b[k])
        h = torch.where(step_mask[:, t, None], hidden, h)
        outs.append(h)
    if not outs:
        return x.new_empty((x.shape[0], 0, n2r))
    return torch.stack(outs, dim=1)


def drnmf_apply_tp_dp(params, config, x, step_mask, mesh: Mesh):
    """The whole forward (recurrence, heads, ratio mask) of this rank's
    rows on a ``dp x tp`` mesh: ``x`` (B, T, F) holds this rank's rows of
    the dp-split batch (the training loop cuts them), the recurrence is
    split over ``tp`` (:func:`drnmf_scan_tp_train`), the heads and mask run
    whole.  The dp gradient sum is the training loop's."""
    from ..models.drnmf import _heads, _ratio_mask

    hs = drnmf_scan_tp_train(params, config, x, step_mask, mesh)
    clean_est, noise_est = _heads(params, config, hs)
    return _ratio_mask(clean_est, noise_est, config.transform_before_irm)
