"""Stacked GRU in the torch convention: one cell, and the plain time sweep.

Port of ``molvax/nn/gru.py``: gate order r|z|n along the 3H axis, and the
reset gate multiplies the hidden product with its bias,
``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``. Weights are in torch
layout: ``weight_ih_l{i}`` (3H, in), ``weight_hh_l{i}`` (3H, H). The sweep
functions take a list of per-layer dicts {w_ih, w_hh, b_ih, b_hh} in that
layout (``gru_layers``), the JAX package's list of layer dicts transposed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..utils import round_to
from .encoder import linear

Layer = Dict[str, torch.Tensor]


def gru_layers(gru: torch.nn.GRU) -> List[Layer]:
    """The weights of ``gru`` (a holder only) as a list of layer dicts."""
    return [
        {
            "w_ih": getattr(gru, f"weight_ih_l{li}"),
            "w_hh": getattr(gru, f"weight_hh_l{li}"),
            "b_ih": getattr(gru, f"bias_ih_l{li}"),
            "b_hh": getattr(gru, f"bias_hh_l{li}"),
        }
        for li in range(gru.num_layers)
    ]


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
    for layer, h in zip(gru_layers(gru), hs):
        inp = gru_cell(
            inp, h, layer["w_ih"], layer["w_hh"], layer["b_ih"], layer["b_hh"], compute_dtype
        )
        new_hs.append(inp)
    return torch.stack(new_hs), inp


def gru_layer_recurrence(
    layer: Layer,
    gi_seq: torch.Tensor,
    h0: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recurrent half of one layer: gi_seq (T, B, 3H) precomputed input
    gates -> (h_seq (T, B, H), h_final (B, H)). Only h @ w_hh stays in the
    loop; the carry is fp32."""
    H = h0.shape[-1]
    w_hh = round_to(layer["w_hh"], compute_dtype).T
    b_hh = layer["b_hh"]
    h = h0
    hs = []
    for gi in gi_seq.unbind(0):
        gh = round_to(h, compute_dtype) @ w_hh + b_hh
        r = torch.sigmoid(gi[:, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, H : 2 * H] + gh[:, H : 2 * H])
        n = torch.tanh(gi[:, 2 * H :] + r * gh[:, 2 * H :])
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs), h


def gru_forward(
    layers: List[Layer],
    x_seq: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full sweep, the plain path: x_seq (B, T, in) -> (outputs (B, T, H),
    h_final (L, B, H)). Layer by layer, each layer's input GEMM hoisted out
    of its time loop: the same math as the reference's per-step scan, with
    sums taken in another order."""
    B = x_seq.shape[0]
    H = layers[0]["w_hh"].shape[1]
    if h0 is None:
        h0 = torch.zeros(len(layers), B, H, device=x_seq.device)
    inp = x_seq.transpose(0, 1)  # (T, B, in)
    finals = []
    for li, layer in enumerate(layers):
        gi = linear(inp, layer["w_ih"], layer["b_ih"], compute_dtype)
        inp, h_final = gru_layer_recurrence(layer, gi, h0[li], compute_dtype)
        finals.append(h_final)
    return inp.transpose(0, 1), torch.stack(finals)
