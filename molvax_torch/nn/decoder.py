"""GRU decoder: latent embedding -> stacked GRU -> per-step charset logits.

Port of ``molvax/nn/decoder.py:39-118``. Both conditionings of the lineage:
'teacher_forced' feeds step t concat(z_emb, one-hot of the character at
t-1), with the zero or learned start vector at step 0; 'repeat_z' tiles
z_emb over T. With ``cfg.use_pallas`` the recurrence goes through the
kernel router (``kernels/gru.py``), else through the plain sweep
(``nn.gru.gru_forward``). The output head is one fp32-accumulate matmul
over all steps. Returns logits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels import gru as kgru
from ..utils import matmul_dtype
from .encoder import dense_act, linear
from .gru import gru_forward, gru_layers, gru_stack_step


def decoder_input_size(cfg) -> int:
    if cfg.decoder_conditioning == "teacher_forced":
        return cfg.latent_dim + cfg.charset_size
    return cfg.latent_dim


def latent_embed(model, cfg, z: torch.Tensor) -> torch.Tensor:
    """selu(linear_3(z)) (relu with ``dense_activation='relu'``), shared by
    training decode and generation."""
    cd = matmul_dtype(cfg, z.device)
    return dense_act(cfg)(linear(z, model.linear_3.weight, model.linear_3.bias, cd))


def decoder_start(model, cfg, B: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A free-running decode's first state: zero hidden states (L, B, H), and
    as the last one-hot (B, C) the learned start vector, or zeros."""
    hs = torch.zeros(model.gru.num_layers, B, cfg.gru_hidden, device=device)
    if model.start_token is None:
        return hs, torch.zeros(B, cfg.charset_size, device=device)
    return hs, model.start_token.float()[None, :].expand(B, cfg.charset_size)


def decoder_step(model, hs: torch.Tensor, z_emb: torch.Tensor, prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A free-running fp32 step, the scan decode's and beam search's: (hidden
    state (L, B, H), z's embedding, the last one-hot) -> (hidden state, logits)."""
    hs, out = gru_stack_step(model.gru, hs, torch.cat([z_emb, prev], dim=-1))
    return hs, linear(out, model.linear_4.weight, model.linear_4.bias)


def teacher_inputs(
    cfg, z_emb: torch.Tensor, x_onehot: torch.Tensor, start: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(B, L) x (B, T, C) -> (B, T, L + C): z_emb tiled, teacher characters
    shifted right one step, the zero or learned ``start`` vector at step 0."""
    B, T, C = x_onehot.shape
    if start is None:
        start_row = x_onehot.new_zeros(B, 1, C)
    else:
        start_row = start.to(x_onehot.dtype)[None, None, :].expand(B, 1, C)
    shifted = torch.cat([start_row, x_onehot[:, :-1, :]], dim=1)
    z_tiled = z_emb[:, None, :].expand(B, T, z_emb.shape[-1])
    return torch.cat([z_tiled, shifted], dim=-1)


def decode(
    model, cfg, z: torch.Tensor, teacher_onehot: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """z (B, latent) -> logits (B, T, C). ``teacher_onehot`` (B, T, C) is
    required by 'teacher_forced' decoders and ignored by 'repeat_z' ones."""
    cd = matmul_dtype(cfg, z.device)
    z_emb = latent_embed(model, cfg, z)
    if cfg.decoder_conditioning == "teacher_forced":
        if teacher_onehot is None:
            raise ValueError(
                "teacher_forced decode needs teacher_onehot; use "
                "molvax_torch.latent.sample.generate for free-running decoding"
            )
        x_seq = teacher_inputs(cfg, z_emb, teacher_onehot, model.start_token)
    else:
        x_seq = z_emb[:, None, :].expand(z.shape[0], cfg.max_len, z_emb.shape[-1])
    layers = gru_layers(model.gru)
    if cfg.use_pallas:
        outputs, _ = kgru.gru_forward_pallas(layers, x_seq, compute_dtype=cd, kernel=cfg.gru_kernel)
    else:
        outputs, _ = gru_forward(layers, x_seq, compute_dtype=cd)
    return linear(outputs, model.linear_4.weight, model.linear_4.bias, cd)
