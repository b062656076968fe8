"""Stacked GRU cell in the torch convention.

Port of ``molvax/nn/gru.py:52-86``: gate order r|z|n along the 3H axis, and
the reset gate multiplies the hidden product with its bias,
``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``. Weights are in torch
layout: ``weight_ih_l{i}`` (3H, in), ``weight_hh_l{i}`` (3H, H).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .encoder import linear


def gru_cell(
    x: torch.Tensor,
    h: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    b_ih: torch.Tensor,
    b_hh: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """One step of one layer. x (B, in), h (B, H) -> h' (B, H), fp32 gates."""
    H = h.shape[-1]
    gi = linear(x, w_ih, b_ih, compute_dtype)
    gh = linear(h, w_hh, b_hh, compute_dtype)
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H : 2 * H] + gh[:, H : 2 * H])
    n = torch.tanh(gi[:, 2 * H :] + r * gh[:, 2 * H :])
    return (1.0 - z) * n + z * h


def gru_stack_step(
    gru: torch.nn.GRU,
    hs: torch.Tensor,
    x: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One time step through all layers of ``gru`` (used as the holder of
    the weights only). hs (L, B, H) -> (hs', top output (B, H))."""
    new_hs = []
    inp = x
    for li in range(gru.num_layers):
        inp = gru_cell(
            inp,
            hs[li],
            getattr(gru, f"weight_ih_l{li}"),
            getattr(gru, f"weight_hh_l{li}"),
            getattr(gru, f"bias_ih_l{li}"),
            getattr(gru, f"bias_hh_l{li}"),
            compute_dtype,
        )
        new_hs.append(inp)
    return torch.stack(new_hs), inp
