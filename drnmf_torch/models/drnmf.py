"""DR-NMF: deep recurrent NMF by unfolding iterative soft-thresholding
(counterpart of ``drnmf_tpu/models/drnmf.py``).

Per timestep t, with h_{t-1} the previous top-layer state:

    layer k:  pre_k = h_{t-1} @ U_k  (+ hidden_{k-1} @ S_k for k>0)  + x_t @ W_k
              hidden_k = act(pre_k + b_k)
    with  U_1 = exp(log_U1)^T (~= I at init),  U_{k>1} = exp(log_Uk)^T (~= 0),
          S_k = (I - Dhat_k^T Dhat_k / alph_k)^T,   W_k = Dhat_k / alph_k,
          b_k = -lam1_k / alph_k,
          Dhat = column-L2-normalized exp(log_D)

Parameters are the flat name -> tensor dict of *alternate* (log-domain)
tensors; layouts are batch-major (B, T, F) in and (B, T, 2r) hidden.  Masked
timesteps (all features == mask_value) hold the carried state.

Routing of the recurrence (``make_scan``), a rule and not an option.  A
"plain" configuration is relu, input to every layer, top layer only, and no
dropout at this call:

- plain, frozen U folded, S factored (every shipped model) ->
  ``ops.drnmf_scan.drnmf_scan_factored``: kernel B1 on CUDA tensors; when
  gradients are needed (grad mode on and an operand requires one) ->
  ``batched_grad.scan_factored_train``: B1 with every layer kept, then the
  backward kernel ``drnmf_scan_factored_backward`` and one product per
  weight gradient;
- plain, U dense (U trains, or a checkpoint whose U broke the fold's
  structure, see ``ensure_fold_valid``) -> ``ops.drnmf_scan.drnmf_scan_dense``
  with S materialised dense: kernel B3 on CUDA tensors; when gradients are
  needed -> the plain time loop (B3 has no backward);
- anything else (dropout, another activation, no input to the layers,
  ``return_all_hidden``, folded U with ``factored_S`` off) -> the plain time
  loop, with or without gradients (autograd through it).

``ops.drnmf_scan.LAUNCHES`` counts each route: its kernels' launches, and
``time_loop`` for each scan the time loop ran.  On CPU tensors the
wrappers run their plain versions.  The recurrence can start from a
carried state (B, 2r) instead of the model's ``h0``, which is how a stream
continues from block to block (``streaming.py``).

Training: ``drnmf_trainable_mask`` says which parameters train; the folded
U fields are detached (the JAX package stops their gradient), so log_U1 and
log_Uk get none on the fold route; variational dropout draws one keep mask
per sequence over (B, 2r) and (B, F) from a ``torch.Generator``
(``dropout_masks``), or takes the masks it is handed.
"""

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.drnmf_scan import LAUNCHES, drnmf_scan_dense, drnmf_scan_factored
from ..utils.profiling import span
from .batched_grad import scan_factored_train

_EPS7 = 1e-7


@dataclass(frozen=True)
class DRNMFConfig:
    input_dim: int = 257
    r: int = 1000  # per-source atoms; hidden dim is 2r
    output_dim: int = 257
    K_layers: int = 2
    alph: float = 400.0
    lam1: float = 1.0
    mask_value: float = -1.0
    untie_alph: bool = False  # alph becomes a (2r,) vector
    params_untied: tuple = ("log_D", "log_alph")
    params_trainable: tuple = ("log_D", "log_alph")
    transform_before_irm: Optional[str] = None  # None | 'square'
    activation: str = "relu"  # relu | tanh | sigmoid | linear
    connect_input_to_layers: bool = True  # x_t fed to every layer k
    nonnegative: bool = True  # h0 = softplus(log_h0); else plain h0
    return_all_hidden: bool = False  # concat all K layers' hidden per step
    dropout_W: float = 0.0  # variational dropout: training only
    dropout_U: float = 0.0
    # kept so configs carry across; nothing reads it.  PyTorch's products
    # (heads, glue, plain versions, weight gradients) run f32 with TF32 off
    # (device.py), B1 and its backward kernel f32 on the CUDA cores, and B2
    # and B3 error-compensated three-pass TF32, whatever this says
    matmul_precision: str = "default"
    # fold the frozen rank-one-structured U matrices into a row-sum
    # (exact up to float reassociation; off whenever U is trainable)
    fold_frozen_U: bool = True
    # apply S_k = I - Dhat^T (Dhat/alph) as two thin F-contraction products
    factored_S: bool = True

    @property
    def hidden_dim(self) -> int:
        return 2 * self.r

    def untied_names(self, base: str) -> list:
        if base in self.params_untied:
            return [f"{base}_{k}" for k in range(self.K_layers)]
        return [base] * self.K_layers


def drnmf_trainable_mask(config: DRNMFConfig, params: dict) -> dict:
    """name -> True where a parameter trains: the listed
    ``params_trainable`` (expanded per layer when untied), the initial state
    (log_h0 or h0) and both head kernels."""
    trainable = set()
    for name in config.params_trainable:
        if name in config.params_untied:
            trainable.update(f"{name}_{k}" for k in range(config.K_layers))
        else:
            trainable.add(name)
    trainable.update({"log_h0", "h0", "log_W_clean", "log_W_noise"})
    return {k: (k in trainable) for k in params}


class FoldedU:
    """Rank-one-structured frozen recurrence matrices: U1 = off1*J +
    diag(diag1 - off1), Uk = c*J, read from the stored params so the folded
    path uses the exact float values the dense path would."""

    __slots__ = ("diag1", "off1", "c")

    def __init__(self, diag1, off1, c):
        self.diag1, self.off1, self.c = diag1, off1, c


def u_is_foldable(config: DRNMFConfig) -> bool:
    """True when the U matrices are frozen (not trainable) and folding is on."""
    return (config.fold_frozen_U
            and "log_U1" not in config.params_trainable
            and "log_Uk" not in config.params_trainable)


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return None if v is None else np.asarray(v)


def fold_structure_holds(params: dict) -> bool:
    """Host-side check of the fold's assumption: log_U1's off-diagonal is
    uniform and log_Uk is a constant matrix (their init form).  FoldedU
    reads only diag(log_U1), log_U1[0,1] and log_Uk[0,0]."""
    lu1 = _host(params.get("log_U1"))
    luk = _host(params.get("log_Uk"))
    if lu1 is None or luk is None or lu1.ndim != 2 or luk.ndim != 2:
        return False
    n = lu1.shape[0]
    if lu1.shape != (n, n) or luk.shape != (n, n):
        return False
    if n > 1:
        off_mask = ~np.eye(n, dtype=bool)
        if not np.all(lu1[off_mask] == lu1[0, 1]):
            return False
    return bool(np.all(luk == luk.flat[0]))


def ensure_fold_valid(config: DRNMFConfig, params: dict,
                      verbose: bool = True) -> DRNMFConfig:
    """Disable the fold (returning an updated config) when loaded params do
    not have the structure it assumes.  Call after every checkpoint load."""
    if not u_is_foldable(config) or fold_structure_holds(params):
        return config
    if verbose:
        print("fold_frozen_U disabled: checkpointed log_U1/log_Uk do not "
              "have the structured init form the rank-one fold assumes "
              "(running the exact dense-U path instead)")
    return dataclasses.replace(config, fold_frozen_U=False)


def s_apply(S_k, hidden):
    """hidden @ S_k, where S_k is a dense (2r, 2r) matrix or the factored
    pair (dk, dka): hidden @ S = hidden - (hidden @ Dhat^T) @ (Dhat/alph)."""
    if isinstance(S_k, tuple):
        dk, dka = S_k
        return hidden - (hidden @ dk.T) @ dka
    return hidden @ S_k


def layer_pre(k, u_k, hidden, x_eff, S, W, config):
    """Bias-free pre-activation of layer k:
    ``u_k (+ hidden @ S_{k-1} for k>0) (+ x_eff @ W_k)``.  With S factored
    and the input to every layer, W_k is the second S factor, so the terms
    fuse into ``u_k + hidden + (x_eff - hidden @ Dhat^T) @ (Dhat/alph)``."""
    if k == 0:
        return u_k + x_eff @ W[0] if config.connect_input_to_layers else u_k
    S_k = S[k - 1]
    if isinstance(S_k, tuple) and config.connect_input_to_layers:
        dk, dka = S_k
        return u_k + hidden + (x_eff - hidden @ dk.T) @ dka
    pre = u_k + s_apply(S_k, hidden)
    if config.connect_input_to_layers:
        pre = pre + x_eff @ W[k]
    return pre


def u_terms(U, h, K: int):
    """Per-layer U contributions [h @ U_k for k in range(K)]: one row-sum for
    a FoldedU, K dense products otherwise."""
    if isinstance(U, FoldedU):
        rs = h.sum(dim=-1, keepdim=True)
        t1 = h * (U.diag1 - U.off1) + U.off1 * rs
        tk = U.c * rs  # (B, 1), broadcasts against (B, 2r)
        return [t1] + [tk] * (K - 1)
    return [h @ U[k] for k in range(K)]


def _effective_matrices(params: dict, config: DRNMFConfig,
                        dense_s: bool = False):
    """Per-layer U, S, W, b from the alternate params (reference
    enhance.py:162-204).  U is a FoldedU when ``u_is_foldable(config)``,
    else K dense (2r, 2r) matrices; each S_k is the pair (Dhat, Dhat/alph)
    when ``config.factored_S`` and not ``dense_s``, else a dense (2r, 2r)
    matrix."""
    K = config.K_layers
    d_names = config.untied_names("log_D")
    a_names = config.untied_names("log_alph")
    l_names = config.untied_names("log_lam1")

    def dhat(k):
        d = torch.exp(params[d_names[k]])
        return d / torch.sqrt(torch.sum(d * d, dim=0, keepdim=True))

    if u_is_foldable(config):
        # U1's off-diagonals are constant and Uk is a constant matrix; both
        # patterns are symmetric, so the transpose is free.  Detached: the
        # fold holds only for a frozen U (the JAX package stops the
        # gradient), so log_U1 and log_Uk get none on this route
        U = FoldedU(
            diag1=torch.exp(torch.diagonal(params["log_U1"])).detach(),
            off1=torch.exp(params["log_U1"][0, 1]).detach(),
            c=torch.exp(params["log_Uk"][0, 0]).detach(),
        )
    else:
        U = [torch.exp(params["log_U1"]).T] + [
            torch.exp(params["log_Uk"]).T for _ in range(K - 1)]
    S = []
    for k in range(1, K):
        dk = dhat(k)
        alph = torch.exp(params[a_names[k]])
        if config.factored_S and not dense_s:
            S.append((dk, dk / alph))
        else:
            eye = torch.eye(config.hidden_dim, dtype=dk.dtype, device=dk.device)
            S.append((eye - (dk / alph).T @ dk).T)
    W = [dhat(k) / torch.exp(params[a_names[k]]) for k in range(K)]
    b = [-torch.ones((config.hidden_dim,), dtype=W[k].dtype, device=W[k].device)
         * torch.exp(params[l_names[k]]) / torch.exp(params[a_names[k]])
         for k in range(K)]
    return U, S, W, b


_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "linear": lambda v: v,
}


def _cell_layers(config, U, S, W, b, h_prev, x_t):
    """One timestep: the K layers' hidden states, bottom to top."""
    act = _ACTIVATIONS[config.activation]
    u = u_terms(U, h_prev, config.K_layers)
    hidden, outs = None, []
    for k in range(config.K_layers):
        hidden = act(layer_pre(k, u[k], hidden, x_t, S, W, config) + b[k])
        outs.append(hidden)
    return outs


def make_cell_step(config: DRNMFConfig, U, S, W, b):
    """One DR-NMF timestep honoring activation / connect_input_to_layers:
    step(h_prev (B, 2r), x_t (B, F)) -> top hidden (B, 2r).  No dropout and
    no return_all_hidden (callers consume the top layer)."""

    def step(h_prev, x_t):
        return _cell_layers(config, U, S, W, b, h_prev, x_t)[-1]

    return step


def _h0(params, config):
    if config.nonnegative:
        return torch.nn.functional.softplus(params["log_h0"])
    return params["h0"]


class BatchRows:
    """A dropout generator's view of a batch split over ranks: the masks
    are drawn for the global batch of ``total`` rows and a call holding
    rows ``[start, start + B)`` keeps those (its padding rows, past
    ``total``, get ones), so every rank draws what one process would."""

    def __init__(self, generator, total: int, start: int):
        self.generator, self.total, self.start = generator, total, start


def dropout_masks(config: DRNMFConfig, bsz: int, f: int, generator,
                  device):
    """Variational dropout's keep masks (b_u (B, 2r), b_w (B, F)), each
    Bernoulli(1 - rate) scaled by 1/(1 - rate), one per sequence, drawn
    with ``generator`` (b_u first); None for a rate of 0.  The JAX
    package's ``_dropout_mask`` (Keras K.dropout).  A :class:`BatchRows`
    generator draws for its global batch and keeps this call's rows (ones
    on padding rows)."""
    rows = None
    if isinstance(generator, BatchRows):
        rows = generator
        generator = rows.generator

    def draw(rate, width):
        if rate <= 0:
            return None
        n = bsz if rows is None else rows.total
        keep = (torch.rand((n, width), generator=generator,
                           device=device) < 1.0 - rate).to(torch.float32)
        if rows is not None:
            keep = torch.cat([keep, keep.new_ones((bsz, width))])[
                rows.start:rows.start + bsz]
        return keep / (1.0 - rate)

    return (draw(config.dropout_U, config.hidden_dim),
            draw(config.dropout_W, f))


def is_plain(config: DRNMFConfig, dropout: bool = False) -> bool:
    """The "plain" test of drnmf_tpu/models/drnmf.py:478-479: relu, input to
    every layer, top layer only, no dropout at this call."""
    return (config.activation == "relu" and config.connect_input_to_layers
            and not config.return_all_hidden and not dropout)


def is_factored_plain(config: DRNMFConfig, U, S) -> bool:
    """The configuration kernels B1 and B2 compute: plain, U folded, S
    factored."""
    return (is_plain(config) and isinstance(U, FoldedU)
            and (config.K_layers == 1 or isinstance(S[0], tuple)))


def is_dense_plain(config: DRNMFConfig, U, S) -> bool:
    """The configuration kernel B3 computes: plain, U and S dense."""
    return (is_plain(config) and not isinstance(U, FoldedU)
            and (config.K_layers == 1 or not isinstance(S[0], tuple)))


def _initial_state(h0, config, bsz, state):
    """The (B, 2r) state the scan starts from: the carried ``state`` when
    given, else the model's ``h0`` for every row."""
    if state is None:
        return h0[None, :].expand(bsz, config.hidden_dim)
    if tuple(state.shape) != (bsz, config.hidden_dim):
        raise ValueError(f"state has shape {tuple(state.shape)}, expected "
                         f"{(bsz, config.hidden_dim)}")
    return state


def _factored_weights(config, U, S, W, b):
    """(diag1, off1, c_uk, dkT stack, dka stack, b stack) of
    ``drnmf_scan_factored``, all contiguous."""
    if S:
        dkt = torch.stack([s[0].T for s in S])
    else:  # K == 1: the kernel never reads it
        dkt = W[0].new_zeros((1, config.hidden_dim, W[0].shape[0]))
    dka = torch.stack([W[0]] + [s[1] for s in S])
    return (U.diag1.contiguous(), U.off1, U.c, dkt, dka, torch.stack(b))


def _dense_weights(config, U, S, W, b):
    """(u1, uk, S stack, W stack, b stack) of ``drnmf_scan_dense``, all
    contiguous.  K == 1: the kernel reads neither uk nor the S dummy."""
    n2r = config.hidden_dim
    uk = U[1] if len(U) > 1 else torch.zeros_like(U[0])
    s_stack = torch.stack(S) if S else W[0].new_zeros((1, n2r, n2r))
    return (U[0].contiguous(), uk.contiguous(), s_stack, torch.stack(W),
            torch.stack(b))


def _scan_operands(h0, config, x, step_mask, weights, state):
    h_init = _initial_state(h0, config, x.shape[0], state).contiguous()
    return (x.contiguous(), step_mask.contiguous(), h_init, *weights)


def factored_scan_operands(params: dict, config: DRNMFConfig, x, step_mask,
                           state=None):
    """The arguments of ``drnmf_scan_factored`` for this model and input:
    (x, step_mask, h0 (B, 2r), diag1, off1, c_uk, dkT stack, dka stack,
    b stack), all contiguous.  Requires ``is_factored_plain``."""
    U, S, W, b = _effective_matrices(params, config)
    if not is_factored_plain(config, U, S):
        raise ValueError("config is not the folded + factored plain form")
    return _scan_operands(_h0(params, config), config, x, step_mask,
                          _factored_weights(config, U, S, W, b), state)


def dense_scan_operands(params: dict, config: DRNMFConfig, x, step_mask,
                        state=None):
    """The arguments of ``drnmf_scan_dense`` for this model and input:
    (x, step_mask, h0 (B, 2r), u1, uk, S stack, W stack, b stack), all
    contiguous.  Requires a plain configuration whose U is not folded."""
    U, S, W, b = _effective_matrices(params, config, dense_s=True)
    if not is_dense_plain(config, U, S):
        raise ValueError("config is not the dense-U plain form")
    return _scan_operands(_h0(params, config), config, x, step_mask,
                          _dense_weights(config, U, S, W, b), state)


def _needs_grad(operands) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in operands)


def make_scan(params: dict, config: DRNMFConfig):
    """Prepare this model's recurrence once (the effective matrices and the
    kernels' weight stacks) and return ``run(x, step_mask, scan_fn=None,
    state=None, dropout=None)``, which has the semantics of
    :func:`_scan_hidden` (``dropout``: the keep masks (b_u, b_w) of this
    call, each a tensor or None).  A caller that scans many inputs with
    fixed parameters (a stream, block after block) keeps the returned
    function.  Traced (``utils.profiling``), the dense route's build of
    U, S, W and b and of B3's weight stacks is the span
    ``drnmf.dense_weights``."""
    K, n2r = config.K_layers, config.hidden_dim
    if is_plain(config) and not u_is_foldable(config):
        with span("drnmf.dense_weights"):
            U, S, W, b = _effective_matrices(params, config, dense_s=True)
            kernel, weights = drnmf_scan_dense, _dense_weights(
                config, U, S, W, b)
    else:
        U, S, W, b = _effective_matrices(params, config)
        if is_factored_plain(config, U, S):
            kernel, weights = drnmf_scan_factored, _factored_weights(
                config, U, S, W, b)
        else:
            kernel = weights = None
    h0 = _h0(params, config)

    def run(x, step_mask, scan_fn=None, state=None, dropout=None):
        if kernel is not None and is_plain(config, dropout is not None):
            operands = _scan_operands(h0, config, x, step_mask, weights, state)
            if not _needs_grad(operands):
                return (kernel if scan_fn is None else scan_fn)(*operands)
            if kernel is drnmf_scan_factored:
                return (scan_factored_train if scan_fn is None
                        else scan_fn)(*operands)
            # dense U with gradients: B3 has no backward, the loop below
        LAUNCHES["time_loop"] += 1
        b_u, b_w = (None, None) if dropout is None else dropout
        carry = _initial_state(h0, config, x.shape[0], state)
        if config.return_all_hidden:
            # carry = concat of all K layers' hidden; the recurrent input is
            # the last block; the initial state tiled K times
            carry = carry.repeat(1, K)
        outs = []
        for t in range(x.shape[1]):
            h_prev = carry[:, -n2r:] if config.return_all_hidden else carry
            x_t = x[:, t]
            if b_u is not None:
                h_prev = h_prev * b_u
            if b_w is not None:
                x_t = x_t * b_w
            layers = _cell_layers(config, U, S, W, b, h_prev, x_t)
            out = (torch.cat(layers, dim=1) if config.return_all_hidden
                   else layers[-1])
            carry = torch.where(step_mask[:, t, None], out, carry)
            outs.append(carry)
        if not outs:
            return x.new_empty((x.shape[0], 0, carry.shape[-1]))
        return torch.stack(outs, dim=1)

    return run


def _scan_hidden(params: dict, config: DRNMFConfig, x, step_mask,
                 scan_fn=None, state=None, training: bool = False,
                 generator=None, dropout=None):
    """Run the recurrence.  x: (B, T, F); step_mask: (B, T) bool.
    Returns hidden states (B, T, 2r), or (B, T, K*2r) with
    ``return_all_hidden``.  The route follows the rule in the module
    docstring.  ``scan_fn`` replaces the route's kernel wrapper
    (``drnmf_scan_factored``, ``drnmf_scan_dense`` or, with gradients,
    ``scan_factored_train``; chip_smoke.py passes the plain versions to
    compare whole paths on the card).  ``state`` (B, 2r) is the top layer's
    state to start from in place of the model's h0; the state after the
    call is the last step of the output (its last 2r columns).

    ``training`` with ``dropout_U`` or ``dropout_W`` set applies
    variational dropout: the keep masks ``dropout`` (b_u (B, 2r) or None,
    b_w (B, F) or None) when given, else drawn from ``generator`` (a
    ``torch.Generator`` on x's device); neither raises ``ValueError``.
    Out of training both are ignored."""
    if not (training and (config.dropout_U > 0 or config.dropout_W > 0)):
        dropout = None
    elif dropout is None:
        if generator is None:
            raise ValueError("dropout requires a generator at training time")
        dropout = dropout_masks(config, x.shape[0], x.shape[-1], generator,
                                x.device)
    return make_scan(params, config)(x, step_mask, scan_fn=scan_fn,
                                     state=state, dropout=dropout)


def _heads(params: dict, config: DRNMFConfig, hidden):
    """Nonnegative reconstruction heads (DenseNonNegW: x @ exp(kernel)).
    With ``return_all_hidden`` the heads consume the top layer's block."""
    top = hidden[..., -config.hidden_dim:]
    clean_est = top[..., : config.r] @ torch.exp(params["log_W_clean"])
    noise_est = top[..., config.r:] @ torch.exp(params["log_W_noise"])
    return clean_est, noise_est


def _ratio_mask(clean_est, noise_est, transform: Optional[str]):
    """Numerically stable A/(A+B) (reference custom_layers.py:41-45)."""
    if transform == "square":
        clean_est = torch.square(clean_est)
        noise_est = torch.square(noise_est)
    return torch.exp(torch.log(_EPS7 + clean_est)
                     - torch.log(_EPS7 + clean_est + noise_est))


def step_mask_from_input(x, mask_value: float):
    """Keras Masking semantics: a timestep is masked iff every feature equals
    mask_value.  (B, T, F) -> (B, T) bool (True = valid)."""
    return torch.any(x != mask_value, dim=-1)


def drnmf_forward(params: dict, config: DRNMFConfig, x,
                  return_parts: bool = False, scan_fn=None, state=None,
                  training: bool = False, generator=None, dropout=None):
    """Noisy magnitude spectrogram (B, T, F) -> ratio mask (B, T, F).  With
    ``return_parts=True`` also returns (hidden, clean_est, noise_est).
    ``scan_fn``, ``state``, ``training``, ``generator`` and ``dropout``:
    see ``_scan_hidden``.  Differentiable in ``params`` (the route with
    gradients follows the module docstring)."""
    step_mask = step_mask_from_input(x, config.mask_value)
    hidden = _scan_hidden(params, config, x, step_mask, scan_fn=scan_fn,
                          state=state, training=training,
                          generator=generator, dropout=dropout)
    clean_est, noise_est = _heads(params, config, hidden)
    irm = _ratio_mask(clean_est, noise_est, config.transform_before_irm)
    if return_parts:
        return irm, hidden, clean_est, noise_est
    return irm


class DRNMF(nn.Module):
    """The model as a module: holds the flat parameter dict, each an
    ``nn.Parameter`` that requires a gradient where
    :func:`drnmf_trainable_mask` says it trains, and runs
    :func:`drnmf_forward`, with dropout in training mode."""

    def __init__(self, config: DRNMFConfig, params: dict):
        super().__init__()
        self.config = config
        trainable = drnmf_trainable_mask(config, params)
        self.params = nn.ParameterDict({
            k: nn.Parameter(torch.as_tensor(v), requires_grad=trainable[k])
            for k, v in params.items()})

    def forward(self, x, return_parts: bool = False, generator=None,
                dropout=None):
        return drnmf_forward(dict(self.params), self.config, x,
                             return_parts=return_parts,
                             training=self.training, generator=generator,
                             dropout=dropout)
