"""Training losses (counterpart of ``drnmf_tpu/train/losses.py``).

* 'mse_of_masked' signal approximation: the model output is redefined as
  ``x * predicted_mask`` and the objective is MSE against the clean
  magnitude ``y``, with the binary frame-validity mask as temporal sample
  weights (Keras's weighted objective): ``sum_t mask_t * mean_F((x_t *
  irm_t - y_t)^2) / max(sum_t mask_t, 1)``.
* SNMF-cost pretraining: ``0.5 * masked-MSE(clean_est + noise_est, x) +
  lam1 * (2r/F) * masked-mean(mean|h|)``, with the same weighting.
"""

import torch


def _step_weights(mask):
    """(B, T) or (B, T, 1) -> (B, T) float weights."""
    if mask.dim() == 3:
        mask = mask[..., 0]
    return mask.to(torch.float32)


def masked_mse_signal_approx(irm, x, y, mask):
    """irm, x, y: (B, T, F); mask: (B, T) or (B, T, 1) binary."""
    mask = _step_weights(mask)
    per_step = torch.mean((x * irm - y) ** 2, dim=-1)  # (B, T)
    return torch.sum(per_step * mask) / torch.clamp(torch.sum(mask), min=1.0)


def snmf_pretrain_loss(clean_est, noise_est, hidden, x, mask, lam1):
    """0.5*masked-MSE(x_recon, x) + lam1*(2r/F)*masked-mean(mean|h|)."""
    mask = _step_weights(mask)
    x_recon = clean_est + noise_est
    mse_step = torch.mean((x_recon - x) ** 2, dim=-1)
    l1_step = torch.mean(torch.abs(hidden), dim=-1)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    weight = lam1 * float(hidden.shape[-1]) / float(x.shape[-1])
    return (0.5 * torch.sum(mse_step * mask) / denom
            + weight * torch.sum(l1_step * mask) / denom)
