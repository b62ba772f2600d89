"""Layer-pipelined DR-NMF recurrence: the K unfolded layers split over the
ranks (counterpart of ``drnmf_tpu/parallel/layerpipe.py``).

Rank ``p`` of ``P = K`` owns layer ``p``: it builds only that layer's W_p
and b_p and, with S factored, Dhat_p and Dhat_p/alph_p (a dense S_p
otherwise) from the parameters, and computes only that layer.  With U
folded, h0 and diag(U1), U1's off-diagonal and Uk's constant are the same
on every rank; with U dense, rank p holds U[min(p, 1)].

Layer K-1's masked-held state at t-1 feeds every layer's U term at t, so
the layers form a ring.  The batch is split into G = P groups run as a
wavefront: rank p at wave s runs group ``(s - p) % G`` at time ``(s - p)
// G`` through its layer, T G + P - 1 waves, and the state of (g, t-1)
comes round the ring to each rank just when it runs (g, t).  Each wave
hands two (B/G, 2r) tensors to the next rank, the layer's output and the
held state in flight; they travel as one tensor (``Mesh.shift``: one
shift a wave).  Rank K-1 writes the output and injects the next step's
state; the output is summed over the ranks, forward only (Megatron's pair
of ``tensor_parallel``: the sum's backward is the identity, so the P
copies of a loss computed from it add their gradient once).

Gradients equal the single-process scan's.  The backward runs the reverse
shifts in reverse wave order on every rank, because each wave's shift
takes the previous wave's output: the waves form one chain, and a zero
term of the final carry keeps every shift of it on the path to the loss on
every rank.  Parameters that more than one rank reads (h0, a tied
dictionary, dense Uk) enter through one sum over the ranks in backward
(identity forward), which runs after the chain; parameters of one layer
keep their gradient on their owner, and the other ranks get none.

No kernel: the layer step is plain PyTorch (the JAX package runs it as XLA
per layer, with no Pallas kernel behind it), a Python loop of waves.
"""

import torch

from .mesh import Mesh
from .tensor_parallel import _FromTP, _ToTP


def check_layer_pipelined(config, shape, n_ranks: int):
    """The refusals of ``drnmf_tpu/parallel/layerpipe.py:53-68`` for an
    input of ``shape`` (B, T, F) over ``n_ranks``."""
    K = config.K_layers
    if K != n_ranks:
        raise ValueError(
            f"K_layers={K} must equal the pp axis size {n_ranks}")
    if K < 2:
        raise ValueError(
            "layer pipelining requires K_layers >= 2; use _scan_hidden")
    if config.return_all_hidden or config.dropout_W or config.dropout_U:
        raise NotImplementedError(
            "layer-pipelined scan supports the plain cell only")
    if not config.connect_input_to_layers:
        raise NotImplementedError(
            "layer-pipelined scan requires connect_input_to_layers")
    if shape[0] % n_ranks:
        raise ValueError(f"B={shape[0]} not divisible by pp={n_ranks}")


def shared_names(config, folded: bool):
    """The parameters more than one rank reads: h0, any tied per-layer
    parameter, and (dense U, more than two layers) log_Uk."""
    names = ["log_h0" if config.nonnegative else "h0"]
    for base in ("log_D", "log_alph", "log_lam1"):
        if base not in config.params_untied:
            names.append(base)
    if not folded and config.K_layers > 2:
        names.append("log_Uk")
    return names


def _layer_weights(p, config, params, folded):
    """Rank ``p``'s layer: (W_p, b_p, S term, U term source), in the
    arithmetic of ``models.drnmf._effective_matrices``."""
    names = {base: config.untied_names(base)[p]
             for base in ("log_D", "log_alph", "log_lam1")}
    d = torch.exp(params[names["log_D"]])
    dhat = d / torch.sqrt(torch.sum(d * d, dim=0, keepdim=True))
    alph = torch.exp(params[names["log_alph"]])
    w = dhat / alph
    b = (-torch.ones((config.hidden_dim,), dtype=w.dtype, device=w.device)
         * torch.exp(params[names["log_lam1"]]) / alph)
    s = None
    if p > 0:
        if config.factored_S:
            s = (dhat, w)
        else:
            eye = torch.eye(config.hidden_dim, dtype=w.dtype, device=w.device)
            s = (eye - w.T @ dhat).T
    if folded:
        # detached: the fold holds only for a frozen U
        u = (torch.exp(torch.diagonal(params["log_U1"])).detach(),
             torch.exp(params["log_U1"][0, 1]).detach(),
             torch.exp(params["log_Uk"][0, 0]).detach())
    else:
        u = torch.exp(params["log_U1" if p == 0 else "log_Uk"]).T
    return w, b, s, u


def drnmf_scan_layer_pipelined(params, config, x, step_mask, mesh: Mesh):
    """Hidden states (B, T, 2r) of the recurrence with layer p on rank p
    (module docstring), the same on every rank.  Requires
    ``K_layers`` equal to the ranks (at least 2), the plain cell with the
    input to every layer, and B divisible by the ranks.  ``x`` (B, T, F)
    and ``step_mask`` (B, T) are whole on every rank, on its device;
    ``params``: name -> tensor there (or array); gradients reach the
    tensors that require one."""
    from ..device import params_on_device
    from ..models.drnmf import _ACTIVATIONS, u_is_foldable

    n_pp = mesh.world
    check_layer_pipelined(config, tuple(x.shape), n_pp)
    p = mesh.rank
    last = p == n_pp - 1
    bsz, t_total, _ = x.shape
    gsz, n2r = bsz // n_pp, config.hidden_dim
    n_items = t_total * n_pp
    act = _ACTIVATIONS[config.activation]
    folded = u_is_foldable(config)
    params = params_on_device(params, x.device)
    grad = torch.is_grad_enabled() and any(
        v.requires_grad for v in params.values())
    flat = None
    shared = [k for k in shared_names(config, folded)
              if grad and k in params and params[k].requires_grad]
    if shared:
        flat = _ToTP.apply(
            torch.cat([params[k].reshape(-1) for k in shared]), mesh, "world")
        at = 0
        params = dict(params)
        for k in shared:
            n = params[k].numel()
            params[k] = flat[at:at + n].view(params[k].shape)
            at += n
    w, b, s, u = _layer_weights(p, config, params, folded)
    h0 = (torch.nn.functional.softplus(params["log_h0"]) if config.nonnegative
          else params["h0"])
    h0_rows = h0[None, :].expand(gsz, n2r)

    def layer(h_prev, hidden, x_t):
        if folded:
            rs = h_prev.sum(dim=-1, keepdim=True)
            u_p = (h_prev * (u[0] - u[1]) + u[1] * rs if p == 0
                   else u[2] * rs)
        else:
            u_p = h_prev @ u
        if p == 0:
            pre = u_p + x_t @ w
        elif isinstance(s, tuple):
            pre = u_p + hidden + (x_t - hidden @ s[0].T) @ s[1]
        else:
            pre = u_p + hidden @ s + x_t @ w
        return act(pre + b)

    # the two carries of a wave, side by side: the layer's output (bh) and
    # layer K-1's held state on its way round (hp)
    carry = x.new_zeros((gsz, 2 * n2r), requires_grad=grad)
    held = {}
    for wave in range(n_items + n_pp - 1):
        recv = mesh.shift(carry)
        idx = wave - p
        if not 0 <= idx < n_items:
            carry = recv  # a bubble passes through
            continue
        g, t = idx % n_pp, idx // n_pp
        rows = slice(g * gsz, (g + 1) * gsz)
        bh_r, hp_r = recv[:, :n2r], recv[:, n2r:]
        h_prev = h0_rows if t == 0 else hp_r
        h_out = layer(h_prev, bh_r, x[rows, t])
        if last:
            h_held = torch.where(step_mask[rows, t, None], h_out, h_prev)
            held[g, t] = h_held
            carry = torch.cat([h_out, h_held], dim=1)
        else:
            carry = torch.cat([h_out, hp_r], dim=1)
    if last and t_total:
        out = torch.stack([torch.stack([held[g, t] for t in range(t_total)],
                                       dim=1) for g in range(n_pp)]
                          ).reshape(bsz, t_total, n2r)
    else:
        out = x.new_zeros((bsz, t_total, n2r))
    out = _FromTP.apply(out, mesh, "world")
    if grad:
        # zero, but on the path to the loss on every rank: every shift of
        # the chain, and the shared parameters' sum, run in backward
        zero = carry.sum() if flat is None else carry.sum() + flat.sum()
        out = out + 0.0 * zero
    return out
