"""GRU decoder pieces on the serving path.

Port of ``molvax/nn/decoder.py:39-64``. The teacher-forced ``decode`` (the
training path) waits for the GRU recurrence kernels; see ROADMAP queue A.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import matmul_dtype
from .encoder import linear


def decoder_input_size(cfg) -> int:
    if cfg.decoder_conditioning == "teacher_forced":
        return cfg.latent_dim + cfg.charset_size
    return cfg.latent_dim


def latent_embed(model, cfg, z: torch.Tensor) -> torch.Tensor:
    """selu(linear_3(z)), shared by training decode and generation."""
    cd = matmul_dtype(cfg, z.device)
    return F.selu(linear(z, model.linear_3.weight, model.linear_3.bias, cd))
