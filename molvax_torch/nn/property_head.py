"""Property regression head: an MLP on z for logP / QED / SAS.

Port of ``molvax/nn/property_head.py``. The head's weights live in
``MolecularVAE`` as ``prop_hidden`` and ``prop_out``; everything is fp32.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from .encoder import linear


def init_property_head(
    cfg, device: Optional[Union[str, torch.device]] = None
) -> Tuple[nn.Linear, nn.Linear]:
    """(hidden, out) layers with torch's default init, the distribution of
    the reference's ``init_linear``."""
    return (
        nn.Linear(cfg.latent_dim, cfg.property_hidden, device=device),
        nn.Linear(cfg.property_hidden, cfg.n_properties, device=device),
    )


def predict_properties(model, cfg, z: torch.Tensor) -> torch.Tensor:
    """z (B, latent) -> (B, n_properties), in normalized units when the
    config carries target stats (see ``normalize_targets``)."""
    h = torch.tanh(linear(z, model.prop_hidden.weight, model.prop_hidden.bias))
    return linear(h, model.prop_out.weight, model.prop_out.bias)


@functools.lru_cache(maxsize=None)
def _stats(mean: Tuple[float, ...], std: Tuple[float, ...], device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The target stats as fp32 tensors on ``device``, made once: a tensor
    from host data is a copy that blocks the host on a CUDA device."""
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(std, dtype=torch.float32, device=device))


def normalize_targets(cfg, targets: torch.Tensor) -> torch.Tensor:
    """Raw property targets -> standardized training targets; identity when
    the config has no stats."""
    if cfg.property_mean is None or cfg.property_std is None:
        return targets
    mean, std = _stats(cfg.property_mean, cfg.property_std, targets.device)
    return (targets.float() - mean) / std


def denormalize_properties(cfg, pred: torch.Tensor) -> torch.Tensor:
    """Head outputs -> raw property units; identity without stats."""
    if cfg.property_mean is None or cfg.property_std is None:
        return pred
    mean, std = _stats(cfg.property_mean, cfg.property_std, pred.device)
    return pred * std + mean
