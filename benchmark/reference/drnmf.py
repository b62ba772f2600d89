"""DR-NMF (Wisdom et al., WASPAA 2017, arXiv:1709.07124) from its
equations: K unfolded ISTA layers over a dictionary of 2r atoms, a
recurrence through the top layer, two nonnegative heads and a ratio mask.
Per frame t, with h the top layer's previous state:

    layer k:  hidden_k = relu(h @ U_k + hidden_{k-1} @ S_k + x_t @ W_k + b_k)
              (no S term at k = 0)
    U_1 = exp(log_U1)^T,  U_k = exp(log_Uk)^T,
    S_k = I - (Dhat_k / alph_k)^T Dhat_k,  W_k = Dhat_k / alph_k,
    b_k = -lam1_k / alph_k,  Dhat = column-normalised exp(log_D)

A masked frame (every feature equal to the mask value) keeps h.  Departures
from the program, on purpose: U and S are dense (2r, 2r) matrices, where
the program folds U into a row-sum and applies S as two thin products; the
layers run as a plain time loop; the ratio mask is the quotient
(eps + clean) / (eps + clean + noise), where the program takes it as the
exponential of a difference of logarithms."""

import torch

from .precision import mm, no_tf32

EPS7 = 1e-7


def _names(config, base):
    if base in config["params_untied"]:
        return [f"{base}_{k}" for k in range(config["K_layers"])]
    return [base] * config["K_layers"]


def init_params(config, w_noisy, u_h0):
    """The alternate parameters of a model that starts from the dictionary
    ``w_noisy`` (F, 2r), unit-norm columns [W_clean, W_noise], and the
    uniform(0, 1) draw ``u_h0`` (2r,) of its initial state: the log of
    1e-7 plus each initial value, as the original initialises them."""
    f, n2r = w_noisy.shape
    r = n2r // 2
    dev = w_noisy.device

    def log_of(v):
        return torch.log(EPS7 + torch.as_tensor(v, dtype=torch.float32,
                                                device=dev))

    params = {
        "log_U1": log_of(torch.eye(n2r, device=dev)),
        "log_Uk": log_of(torch.zeros((n2r, n2r), device=dev)),
        "log_W_clean": log_of(w_noisy[:, :r].T.contiguous()),
        "log_W_noise": log_of(w_noisy[:, r:].T.contiguous()),
        "log_h0": u_h0.to(dev) * 0.1 - 0.05,
    }
    for base, value in (("log_D", w_noisy), ("log_alph", config["alph"]),
                        ("log_lam1", config["lam1"])):
        for name in set(_names(config, base)):
            params[name] = log_of(value).clone()
    return params


def layers(params, config, precision="f32"):
    """U, S, W, b of every layer."""
    k_layers = config["K_layers"]
    d_names = _names(config, "log_D")
    a_names = _names(config, "log_alph")
    l_names = _names(config, "log_lam1")
    u, s, w, b = [], [], [], []
    for k in range(k_layers):
        d = torch.exp(params[d_names[k]])
        dhat = d / torch.sqrt((d * d).sum(dim=0, keepdim=True))
        alph = torch.exp(params[a_names[k]])
        w.append(dhat / alph)
        b.append(-torch.exp(params[l_names[k]]) / alph)
        u.append(torch.exp(params["log_U1" if k == 0 else "log_Uk"]).T)
        if k > 0:
            eye = torch.eye(dhat.shape[1], device=dhat.device)
            s.append(eye - mm((dhat / alph).T, dhat, precision))
    return u, s, w, b


def scan(params, config, x, step_mask, precision="f32"):
    """The top layer's state at every frame: x (B, T, F), step_mask (B, T)
    bool -> (B, T, 2r)."""
    u, s, w, b = layers(params, config, precision)
    h0 = torch.nn.functional.softplus(params["log_h0"])
    h = h0[None, :].expand(x.shape[0], -1)
    out = []
    for t in range(x.shape[1]):
        x_t = x[:, t]
        hidden = None
        for k in range(config["K_layers"]):
            pre = mm(h, u[k], precision) + mm(x_t, w[k], precision)
            if k > 0:
                pre = pre + mm(hidden, s[k - 1], precision)
            hidden = torch.relu(pre + b[k])
        h = torch.where(step_mask[:, t, None], hidden, h)
        out.append(h)
    return torch.stack(out, dim=1)


def ratio_mask(params, config, x, precision="f32"):
    """Noisy magnitudes (B, T, F) -> the ratio mask (B, T, F)."""
    no_tf32()
    r = config["r"]
    step_mask = (x != config["mask_value"]).any(dim=-1)
    top = scan(params, config, x, step_mask, precision)
    clean = mm(top[..., :r], torch.exp(params["log_W_clean"]), precision)
    noise = mm(top[..., r:], torch.exp(params["log_W_noise"]), precision)
    return (EPS7 + clean) / (EPS7 + clean + noise)


def masked_mse(irm, x, y, mask):
    """The signal-approximation loss: the mean over features of
    (x * irm - y)^2, weighted by the valid frames (mask (B, T, 1))."""
    weight = mask[..., 0]
    per_step = ((x * irm - y) ** 2).mean(dim=-1)
    return (per_step * weight).sum() / weight.sum().clamp_min(1.0)


def train_steps(params, trainable, config, batches, lr, precision="f32"):
    """Adam (Keras 2: b1 0.9, b2 0.999, eps 1e-8 outside the root) on the
    ``trainable`` parameters over ``batches`` of (x, y, mask), one step
    each.  Returns (losses, the first step's gradient norm by name, the
    norm of each trained parameter's change after the last step)."""
    start = {k: v.detach().clone() for k, v in params.items()}
    p = {k: v.detach().clone().requires_grad_(k in trainable)
         for k, v in params.items()}
    mu = {k: torch.zeros_like(p[k]) for k in trainable}
    nu = {k: torch.zeros_like(p[k]) for k in trainable}
    losses, first = [], None
    for n, (x, y, mask) in enumerate(batches, 1):
        loss = masked_mse(ratio_mask(p, config, x, precision), x, y, mask)
        grads = torch.autograd.grad(loss, [p[k] for k in trainable])
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: float(g.norm()) for k, g in zip(trainable, grads)}
        with torch.no_grad():
            for k, g in zip(trainable, grads):
                mu[k] = 0.9 * mu[k] + 0.1 * g
                nu[k] = 0.999 * nu[k] + 0.001 * g * g
                step = (mu[k] / (1 - 0.9 ** n)) / (
                    torch.sqrt(nu[k] / (1 - 0.999 ** n)) + 1e-8)
                p[k] -= lr * step
        del loss, grads
    change = {k: float((p[k].detach() - start[k]).norm()) for k in trainable}
    return losses, first, change
