"""MolecularVAE: the port's parameter holder, plus encode and reparameterize.

Port of ``molvax/nn/vae.py:44-67``. Module names are those of the reference
twin (``bench/torch_twin/model.py``): ``conv_1..N``, ``linear_0`` (dense),
``linear_1`` (mu), ``linear_2`` (logvar), ``linear_3`` (latent embed),
``gru`` (weights only: the port never runs ``nn.GRU``'s forward),
``linear_4`` (output head), ``prop_hidden``/``prop_out`` when the config has
a property head, and ``start_token`` when it learns one. A state dict from
``io.convert.state_dict_from_jax`` loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from ..data.featurize import one_hot
from ..utils import resolve_device
from .decoder import decoder_input_size
from .encoder import conv_input_channels, encode as _encode, flat_conv_dim


class MolecularVAE(nn.Module):
    def __init__(self, cfg, device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        dev = resolve_device(device)
        in_ch = conv_input_channels(cfg)
        for i, (out_ch, k) in enumerate(
            zip(cfg.conv_channels, cfg.conv_kernels), start=1
        ):
            setattr(self, f"conv_{i}", nn.Conv1d(in_ch, out_ch, k, device=dev))
            in_ch = out_ch
        self.linear_0 = nn.Linear(flat_conv_dim(cfg), cfg.enc_hidden, device=dev)
        self.linear_1 = nn.Linear(cfg.enc_hidden, cfg.latent_dim, device=dev)
        self.linear_2 = nn.Linear(cfg.enc_hidden, cfg.latent_dim, device=dev)
        self.linear_3 = nn.Linear(cfg.latent_dim, cfg.latent_dim, device=dev)
        self.gru = nn.GRU(
            decoder_input_size(cfg),
            cfg.gru_hidden,
            cfg.gru_layers,
            batch_first=True,
            device=dev,
        )
        self.linear_4 = nn.Linear(cfg.gru_hidden, cfg.charset_size, device=dev)
        if cfg.n_properties > 0:
            self.prop_hidden = nn.Linear(cfg.latent_dim, cfg.property_hidden, device=dev)
            self.prop_out = nn.Linear(cfg.property_hidden, cfg.n_properties, device=dev)
        self.start_token = (
            nn.Parameter(torch.zeros(cfg.charset_size, device=dev))
            if cfg.learned_start
            else None
        )
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.linear_0.weight.device

    def encode(self, codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return encode(self, self.cfg, codes)


def encode(model: MolecularVAE, cfg, codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """codes (B, T) integer -> (mu, logvar). The one-hot is built on the
    codes' device."""
    return _encode(model, cfg, one_hot(codes, cfg.charset_size))


def reparameterize(
    mu: torch.Tensor,
    logvar: torch.Tensor,
    eps_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """z = mu + eps_scale * exp(0.5*logvar) * eps, eps ~ N(0, I) drawn from
    ``generator`` (on its own device, then moved to mu's)."""
    gen_device = generator.device if generator is not None else mu.device
    eps = torch.randn(mu.shape, generator=generator, device=gen_device).to(mu.device)
    return mu + eps_scale * torch.exp(0.5 * logvar) * eps
