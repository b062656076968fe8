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

from ..data.featurize import one_hot
from ..kernels import generate as kgen
from ..kernels import gru as kgru
from ..utils import matmul_dtype, span
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


class PlainStep:
    """``kernels.generate.FusedStep``'s interface over ``decoder_step``, the
    CPU's step: hidden states (L, B, H), the last codes made one-hot, the
    scores logits / temperature + noise as the plain scan computes them, the
    first maximum under the span ``sample.select``."""

    def __init__(self, model, cfg, z_emb: torch.Tensor):
        self.model, self.z_emb, self.C = model, z_emb, cfg.charset_size
        self.hs, self.start = decoder_start(model, cfg, z_emb.shape[0], z_emb.device)

    def state(self, *lead: int) -> torch.Tensor:
        """Zero hidden states, (*lead, L, B, H): the decode's first."""
        return self.hs.new_zeros(*lead, *self.hs.shape)

    def step(self, h: torch.Tensor, h_out: torch.Tensor, prev: Optional[torch.Tensor], logits: torch.Tensor,
             scores: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None, temperature: float = 1.0,
             codes: Optional[torch.Tensor] = None) -> None:
        """``FusedStep.step``: ``h`` -> ``h_out``, the logits into ``logits``,
        the scores into ``scores`` and their first maximum into ``codes``;
        ``prev`` the last codes, None at t = 0 (the start vector)."""
        hs, lg = decoder_step(self.model, h, self.z_emb, self.start if prev is None else one_hot(prev, self.C))
        h_out.copy_(hs)
        logits.copy_(lg)
        sc = lg if noise is None else lg / temperature + noise
        if scores is not None:
            scores.copy_(sc)
        if codes is not None:
            with span("sample.select"):
                codes.copy_(torch.argmax(sc, dim=-1))


def decoder_stepper(model, cfg, z_emb: torch.Tensor):
    """The free-running fp32 decoder of one decode, the scan route's and beam
    search's: on a card the hand-written step kernels
    (``kernels.generate.FusedStep``), elsewhere ``PlainStep``."""
    if z_emb.device.type == "cuda":
        return kgen.FusedStep(model, z_emb)
    return PlainStep(model, cfg, z_emb)


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
