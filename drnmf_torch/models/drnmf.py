"""DR-NMF: deep recurrent NMF by unfolding iterative soft-thresholding
(inference side; counterpart of ``drnmf_tpu/models/drnmf.py``).

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

The recurrence of the configuration every shipped model uses (relu, input to
every layer, frozen U folded, S factored) goes through
``ops.drnmf_scan.drnmf_scan_factored``: kernel B1 on CUDA tensors, its plain
version on CPU tensors.  Every other configuration runs the plain time loop
in ``_scan_hidden``.  Dropout and training belong to the training side.
"""

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.drnmf_scan import drnmf_scan_factored

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
    # kept so configs carry across; the card runs every matmul in full f32
    # either way ('default' and 'highest' compute the same here)
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


def _effective_matrices(params: dict, config: DRNMFConfig):
    """Per-layer U, S, W, b from the alternate params (reference
    enhance.py:162-204).  U is a FoldedU when ``u_is_foldable(config)``,
    else K dense (2r, 2r) matrices; each S_k is the pair (Dhat, Dhat/alph)
    when ``config.factored_S``, else a dense (2r, 2r) matrix."""
    K = config.K_layers
    d_names = config.untied_names("log_D")
    a_names = config.untied_names("log_alph")
    l_names = config.untied_names("log_lam1")

    def dhat(k):
        d = torch.exp(params[d_names[k]])
        return d / torch.sqrt(torch.sum(d * d, dim=0, keepdim=True))

    if u_is_foldable(config):
        # U1's off-diagonals are constant and Uk is a constant matrix; both
        # patterns are symmetric, so the transpose is free
        U = FoldedU(
            diag1=torch.exp(torch.diagonal(params["log_U1"])),
            off1=torch.exp(params["log_U1"][0, 1]),
            c=torch.exp(params["log_Uk"][0, 0]),
        )
    else:
        U = [torch.exp(params["log_U1"]).T] + [
            torch.exp(params["log_Uk"]).T for _ in range(K - 1)]
    S = []
    for k in range(1, K):
        dk = dhat(k)
        alph = torch.exp(params[a_names[k]])
        if config.factored_S:
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


def is_factored_plain(config: DRNMFConfig, U, S) -> bool:
    """The configuration kernel B1 computes (the "plain" test of
    drnmf_tpu/models/drnmf.py:478-479, plus the fold and the factoring):
    relu, input to every layer, top layer only, U folded, S factored."""
    return (config.activation == "relu" and config.connect_input_to_layers
            and not config.return_all_hidden and isinstance(U, FoldedU)
            and (config.K_layers == 1 or isinstance(S[0], tuple)))


def _factored_operands(params, config, x, step_mask, U, S, W, b):
    bsz, n2r = x.shape[0], config.hidden_dim
    h_init = _h0(params, config)[None, :].expand(bsz, n2r).contiguous()
    if S:
        dkt = torch.stack([s[0].T for s in S])
    else:  # K == 1: the kernel never reads it
        dkt = x.new_zeros((1, n2r, x.shape[-1]))
    dka = torch.stack([W[0]] + [s[1] for s in S])
    return (x.contiguous(), step_mask.contiguous(), h_init, U.diag1.contiguous(),
            U.off1, U.c, dkt, dka, torch.stack(b))


def factored_scan_operands(params: dict, config: DRNMFConfig, x, step_mask):
    """The arguments of ``drnmf_scan_factored`` for this model and input:
    (x, step_mask, h0 (B, 2r), diag1, off1, c_uk, dkT stack, dka stack,
    b stack), all contiguous.  Requires ``is_factored_plain``."""
    U, S, W, b = _effective_matrices(params, config)
    if not is_factored_plain(config, U, S):
        raise ValueError("config is not the folded + factored plain form")
    return _factored_operands(params, config, x, step_mask, U, S, W, b)


def _scan_hidden(params: dict, config: DRNMFConfig, x, step_mask,
                 scan_fn=None):
    """Run the recurrence.  x: (B, T, F); step_mask: (B, T) bool.
    Returns hidden states (B, T, 2r), or (B, T, K*2r) with
    ``return_all_hidden``.  ``scan_fn`` replaces ``drnmf_scan_factored``
    (chip_smoke.py passes the plain version through ``enhance_signals`` to
    compare the whole path on the card)."""
    K = config.K_layers
    U, S, W, b = _effective_matrices(params, config)
    if is_factored_plain(config, U, S):
        scan = drnmf_scan_factored if scan_fn is None else scan_fn
        return scan(*_factored_operands(params, config, x, step_mask,
                                        U, S, W, b))

    bsz, n2r = x.shape[0], config.hidden_dim
    carry = _h0(params, config)[None, :].expand(bsz, n2r)
    if config.return_all_hidden:
        # carry = concat of all K layers' hidden; the recurrent input is the
        # last block; h0 tiled K times
        carry = carry.repeat(1, K)
    outs = []
    for t in range(x.shape[1]):
        h_prev = carry[:, -n2r:] if config.return_all_hidden else carry
        layers = _cell_layers(config, U, S, W, b, h_prev, x[:, t])
        out = torch.cat(layers, dim=1) if config.return_all_hidden else layers[-1]
        carry = torch.where(step_mask[:, t, None], out, carry)
        outs.append(carry)
    return torch.stack(outs, dim=1)


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
                  return_parts: bool = False, scan_fn=None):
    """Noisy magnitude spectrogram (B, T, F) -> ratio mask (B, T, F).  With
    ``return_parts=True`` also returns (hidden, clean_est, noise_est).
    ``scan_fn``: see ``_scan_hidden``."""
    step_mask = step_mask_from_input(x, config.mask_value)
    hidden = _scan_hidden(params, config, x, step_mask, scan_fn=scan_fn)
    clean_est, noise_est = _heads(params, config, hidden)
    irm = _ratio_mask(clean_est, noise_est, config.transform_before_irm)
    if return_parts:
        return irm, hidden, clean_est, noise_est
    return irm


class DRNMF(nn.Module):
    """The model as a module: holds the flat parameter dict and runs
    :func:`drnmf_forward`.  Inference only for now: the parameters do not
    require gradients."""

    def __init__(self, config: DRNMFConfig, params: dict):
        super().__init__()
        self.config = config
        self.params = nn.ParameterDict({
            k: nn.Parameter(torch.as_tensor(v), requires_grad=False)
            for k, v in params.items()})

    def forward(self, x, return_parts: bool = False):
        return drnmf_forward(dict(self.params), self.config, x,
                             return_parts=return_parts)
