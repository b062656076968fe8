"""Conv1d encoder stack -> (mu, logvar) heads.

Port of ``molvax/nn/encoder.py``: three VALID Conv1d layers with ReLU,
flatten (channel-major), Linear + SELU (or ReLU: ``dense_activation``),
then the mu and logvar heads. Both
conv orientations of the reference lineage: 'seq' convolves along the T
positions with the charset as channels, 'charset' along the charset axis with
the positions as channels. Weights are in torch layout (``nn.Linear``
(out, in), ``nn.Conv1d`` (out, in, k)); the heads stay fp32 whatever the
compute dtype, as in the reference.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils import matmul_dtype, round_to


def linear(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """x @ weight.T + bias, operands rounded to ``compute_dtype``, fp32
    accumulation and output."""
    return round_to(x, compute_dtype) @ round_to(weight, compute_dtype).T + bias


def _strict_flags(deterministic: bool):
    """cuDNN's flags for a strict-fp32 conv: TF32 off (fp32 operands are
    not exact in TF32; bf16-rounded ones are)."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(
        enabled=True,  # the helper's default would turn cuDNN off
        benchmark=cudnn.benchmark,
        benchmark_limit=cudnn.benchmark_limit,
        deterministic=deterministic,
        allow_tf32=False,
    )


class _StrictConv1d(torch.autograd.Function):
    """``F.conv1d(x, w)`` in fp32 with TF32 off in the forward and in the
    backward, and a backward that gives the same bits every run. Autograd
    runs a backward after the forward's flags are gone (so it would run in
    TF32), and cuDNN's default weight gradient sums in an order that varies
    from run to run: two runs of a strict-fp32 step, or a step and its CUDA
    Graph replay, would differ. The weight gradient is one fp32 GEMM over
    (batch, position) of the gradient against the unfolded input (cuDNN's
    deterministic fp32 weight gradients at these shapes are FFT-based and
    cost ~3 ms a step on an H100); the input gradient is cuDNN's
    transposed conv on its deterministic algorithms."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _strict_flags(torch.backends.cudnn.deterministic):
            return F.conv1d(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[1]:
            out_ch, in_ch, k = w.shape
            cols = x.unfold(2, k, 1)  # (B, C_in, W_out, k)
            rows = cols.shape[0] * cols.shape[2]
            gw = g.transpose(0, 1).reshape(out_ch, rows) @ cols.transpose(1, 2).reshape(rows, in_ch * k)
            gw = gw.reshape(out_ch, in_ch, k)
        if ctx.needs_input_grad[0]:
            with _strict_flags(True):
                gx = F.conv_transpose1d(g, w)
        return gx, gw


def conv1d(
    x_nch: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """VALID 1-D conv in torch layout: (B, C_in, W) -> (B, C_out, W-k+1).

    The operands are rounded to ``compute_dtype`` and the conv runs in
    fp32. cuDNN runs fp32 convolutions in TF32 by default; bf16-rounded
    operands are exact in TF32, but fp32 ones are not, so a 'float32'
    conv turns TF32 off for its forward and its backward
    (``_StrictConv1d``)."""
    x, w = round_to(x_nch, compute_dtype), round_to(weight, compute_dtype)
    if compute_dtype == torch.float32:
        out = _StrictConv1d.apply(x, w)
    else:
        out = F.conv1d(x, w)
    return out + bias[None, :, None]


def dense_act(cfg):
    """The activation of the encoder's dense layer and the decoder's latent
    embedding (``ModelConfig.dense_activation``)."""
    return F.relu if cfg.dense_activation == "relu" else F.selu


def conv_input_channels(cfg) -> int:
    return cfg.charset_size if cfg.conv_orientation == "seq" else cfg.max_len


def conv_spatial_len(cfg) -> int:
    """Spatial length after the VALID conv stack."""
    w = cfg.max_len if cfg.conv_orientation == "seq" else cfg.charset_size
    for k in cfg.conv_kernels:
        w = w - k + 1
    if w <= 0:
        raise ValueError(
            f"conv stack consumes the whole axis (len {w}); check "
            f"conv_orientation={cfg.conv_orientation!r} vs charset_size/max_len"
        )
    return w


def flat_conv_dim(cfg) -> int:
    return cfg.conv_channels[-1] * conv_spatial_len(cfg)


def encoder_params(model) -> Tuple[torch.Tensor, ...]:
    """The encoder's tensors in the order ``encode_with`` reads them:
    (w, b) of each conv, then of ``linear_0``, ``linear_1`` (mu) and
    ``linear_2`` (logvar)."""
    out = []
    for i in range(1, len(model.cfg.conv_channels) + 1):
        conv = getattr(model, f"conv_{i}")
        out += [conv.weight, conv.bias]
    for name in ("linear_0", "linear_1", "linear_2"):
        lin = getattr(model, name)
        out += [lin.weight, lin.bias]
    return tuple(out)


def encode_with(
    cfg, x_onehot: torch.Tensor, params: Sequence[torch.Tensor], compute_dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder as a function of its tensors (``encoder_params`` order):
    x_onehot (B, T, C) -> (mu, logvar), each (B, latent_dim) fp32."""
    n_conv = len(cfg.conv_channels)
    h = x_onehot.transpose(1, 2) if cfg.conv_orientation == "seq" else x_onehot
    for i in range(n_conv):
        h = F.relu(conv1d(h, params[2 * i], params[2 * i + 1], compute_dtype))
    h = h.reshape(h.shape[0], -1)
    w0, b0, w_mu, b_mu, w_lv, b_lv = params[2 * n_conv :]
    h = dense_act(cfg)(linear(h, w0, b0, compute_dtype))
    return linear(h, w_mu, b_mu), linear(h, w_lv, b_lv)


def encode(model, cfg, x_onehot: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_onehot (B, T, C) -> (mu, logvar), each (B, latent_dim) fp32.

    ``model`` is a ``nn.vae.MolecularVAE`` (its ``conv_i`` and
    ``linear_0..2`` modules hold the weights)."""
    return encode_with(
        cfg, x_onehot, encoder_params(model), matmul_dtype(cfg, x_onehot.device)
    )
