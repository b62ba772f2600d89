"""The recurrence matrices of a DR-NMF whose U was trained (the original
code's trainable ``log_U1``/``log_Uk``): a seeded draw that stands in for
training, made here from the seed so that the reference has the same U as
the program without reading the program's tensors.  The model's equations
are ``drnmf.py``'s, unchanged: U_1 = exp(log_U1)^T, U_k = exp(log_Uk)^T,
and U and S dense."""

import torch

from .drnmf import EPS7


def draw_log_u(config, seed):
    """(log_U1, log_Uk), each (2r, 2r) float32 on the CPU, drawn from
    ``seed`` as ``config["u_draw"]`` says: the initial values
    log(1e-7 + I) and log(1e-7 + 0) shifted down by uniform(0,
    ``log_U1_shift``) and uniform(0, ``log_Uk_shift``) (so U's entries
    shrink by factors in [exp(-shift), 1]); then uniform(0, ``added``)
    added to U_1's off-diagonal entries and to every entry of U_k."""
    draw = config["u_draw"]
    n2r = 2 * int(config["r"])
    gen = torch.Generator().manual_seed(int(seed))

    def uniform(high):
        return torch.rand((n2r, n2r), generator=gen) * float(high)

    eye = torch.eye(n2r)
    log_u1 = torch.log(EPS7 + eye) - uniform(draw["log_U1_shift"])
    log_uk = torch.log(EPS7 + torch.zeros((n2r, n2r))) - uniform(
        draw["log_Uk_shift"])
    u1 = torch.exp(log_u1) + (1.0 - eye) * uniform(draw["added"])
    uk = torch.exp(log_uk) + uniform(draw["added"])
    return torch.log(u1), torch.log(uk)
