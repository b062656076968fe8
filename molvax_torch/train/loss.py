"""KL-annealed ELBO (+ optional multi-task property loss) and metrics.

Port of ``molvax/train/loss.py``: per-molecule sums, batch mean; everything
fp32 whatever the matmul dtype. 'ce' is the per-character cross-entropy of
the decoder's distribution, 'bce' the compact port's binary cross-entropy
of the softmax against the one-hot.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..data.featurize import one_hot
from ..nn.property_head import normalize_targets


def recon_ce(logits: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Per-sample summed cross-entropy. logits (B, T, C), codes (B, T) -> (B,)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, codes.long()[..., None])
    return nll[..., 0].sum(dim=-1)


def recon_bce(logits: torch.Tensor, codes: torch.Tensor, charset_size: int) -> torch.Tensor:
    """BCE of softmax(logits) against the one-hot, per-sample sum."""
    probs = torch.softmax(logits.float(), dim=-1)
    x = one_hot(codes, charset_size)
    eps = 1e-12
    bce = -(x * torch.log(probs + eps) + (1.0 - x) * torch.log(1.0 - probs + eps))
    return bce.sum(dim=(-1, -2))


def gaussian_kl_per_dim(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Per-dimension KL terms (B, L): -0.5 * (1 + logvar - mu^2 - e^logvar)."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * (1.0 + logvar - mu * mu - torch.exp(logvar))


def gaussian_kl(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Per-sample KL(q(z|x) || N(0, I)), (B,)."""
    return gaussian_kl_per_dim(mu, logvar).sum(dim=-1)


def recon_accuracy(
    logits: torch.Tensor, codes: torch.Tensor, pad_index: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced character accuracy over all positions, and over the
    non-pad positions only."""
    hit = (logits.argmax(dim=-1) == codes).float()
    nonpad = (codes != pad_index).float()
    return hit.mean(), (hit * nonpad).sum() / torch.clamp(nonpad.sum(), min=1.0)


def post_std_batch(mu: torch.Tensor, logvar: torch.Tensor, eps_scale: float) -> torch.Tensor:
    """In-batch aggregate-z std per latent dim, averaged: sqrt(var(mu) +
    eps_scale^2 * mean(exp(logvar))). Collapse drives it toward eps_scale."""
    mu, logvar = mu.float(), logvar.float()
    var_z = mu.var(dim=0, unbiased=False) + (eps_scale**2) * torch.exp(logvar).mean(dim=0)
    return torch.sqrt(var_z).mean()


def vae_loss(
    cfg,
    logits: torch.Tensor,
    codes: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    beta: Union[float, torch.Tensor],
    properties_pred: Optional[torch.Tensor] = None,
    properties_true: Optional[torch.Tensor] = None,
    property_loss_weight: float = 1.0,
    kl: Optional[torch.Tensor] = None,
    kl_free_bits: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(scalar loss, metrics of batch means). ``kl`` may come precomputed
    (the fused sampler). ``kl_free_bits`` > 0 floors each latent dim's KL at
    that many nats in the loss only; the 'kl' metric stays the true KL.
    ``beta``: a float, or a 0-d fp32 tensor on the loss device (a train
    step's, read from its schedule vector on the card)."""
    if cfg.recon_loss == "ce":
        recon = recon_ce(logits, codes)
    else:
        recon = recon_bce(logits, codes, cfg.charset_size)
    if kl is None:
        kl = gaussian_kl(mu, logvar)
    if kl_free_bits > 0.0:
        kl_loss = torch.clamp(gaussian_kl_per_dim(mu, logvar), min=kl_free_bits).sum(dim=-1)
    else:
        kl_loss = kl
    loss = (recon + beta * kl_loss).mean()
    metrics: Dict[str, torch.Tensor] = {
        "loss": loss,
        "recon": recon.mean(),
        "kl": kl.mean(),
        "elbo": (recon + kl).mean(),  # beta = 1 ELBO, comparable across schedules
        # made on the device: a tensor from host data is a blocking copy
        "beta": beta if isinstance(beta, torch.Tensor) else torch.full((), float(beta), device=loss.device),
    }
    metrics["acc"], metrics["acc_nonpad"] = recon_accuracy(logits, codes)
    metrics["post_std_batch"] = post_std_batch(mu, logvar, cfg.eps_scale)
    if properties_pred is not None and properties_true is not None:
        target = normalize_targets(cfg, properties_true)
        per_prop = ((properties_pred - target) ** 2).mean(dim=0)  # (P,)
        prop_mse = per_prop.sum()
        loss = loss + property_loss_weight * prop_mse
        metrics["prop_mse"] = prop_mse
        for i in range(cfg.n_properties):
            metrics[f"prop_mse_{i}"] = per_prop[i]
        metrics["loss"] = loss
    return loss, metrics
