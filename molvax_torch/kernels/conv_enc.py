"""Fused conv encoder: wrapper and plain version.

Port of ``molvax/kernels/conv_enc.py:114-205``. ``fused_encode`` maps codes
(B, T) to (mu, logvar) in one launch of the hand-written kernel
``csrc/conv_enc.cu``, which builds the one-hot in shared memory. Its plain
version is the port's encoder on the one-hot (``fused_encode_ref``), which
rounds where the kernel rounds: bf16 operands, bf16 between the conv
stages, fp32 heads. The gradient, as in the reference, is autograd of the
plain encoder, recomputed in the backward. For CUDA tensors the forward
launches the kernel or raises; the plain version runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..data.featurize import one_hot
from ..nn.encoder import conv_spatial_len, encode_with, encoder_params
from ..utils import matmul_dtype
from . import _build

# kernel launches made by fused_encode (not by the plain version)
launches = 0


def fused_encode_ref(model, cfg, codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the port's encoder on ``one_hot(codes)``."""
    return encode_with(
        cfg, one_hot(codes, cfg.charset_size), encoder_params(model), matmul_dtype(cfg, codes.device)
    )


def _encode_kernel(cfg, codes: torch.Tensor, params) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"fused_encode: unsupported device {dev}")
    if any(p.device != dev for p in params):
        raise ValueError("fused_encode: model and codes are on different devices")
    if codes.dim() != 2 or codes.shape[1] != cfg.max_len or codes.shape[0] == 0:
        raise ValueError(f"fused_encode: codes must be (B>0, {cfg.max_len}), got {tuple(codes.shape)}")
    n_conv = len(cfg.conv_channels)
    B, T, C = codes.shape[0], cfg.max_len, cfg.charset_size
    seq = cfg.conv_orientation == "seq"
    conv_spatial_len(cfg)  # raises if the convs consume the axis
    width, act = (T if seq else C), [T * C]
    for ch, k in zip(cfg.conv_channels, cfg.conv_kernels):
        width -= k - 1
        act.append(ch * width)
    w0, b0, w_mu, b_mu, w_lv, b_lv = params[2 * n_conv :]
    E, Lz = w0.shape[0], w_mu.shape[0]
    bf = torch.bfloat16
    with torch.no_grad():
        codes32 = codes.to(torch.int32).contiguous()
        wconv = torch.cat([params[2 * i].to(bf).reshape(-1) for i in range(n_conv)])
        bconv = torch.cat([params[2 * i + 1].float().reshape(-1) for i in range(n_conv)])
        w0_t = w0.t().to(bf).contiguous()  # (F, E), F in channel-major (NCH) order
        w_mu_t, w_lv_t = w_mu.t().float().contiguous(), w_lv.t().float().contiguous()
        b0_, b_mu_, b_lv_ = (b.float().contiguous() for b in (b0, b_mu, b_lv))
    mu = torch.empty(B, Lz, device=dev)
    logvar = torch.empty(B, Lz, device=dev)
    ints = ctypes.c_int * n_conv
    fn = _build.function(
        "molvax_fused_encode",
        [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    )
    err = fn(
        codes32.data_ptr(), wconv.data_ptr(), bconv.data_ptr(), n_conv,
        ints(*cfg.conv_channels), ints(*cfg.conv_kernels),
        *(t.data_ptr() for t in (w0_t, b0_, w_mu_t, b_mu_, w_lv_t, b_lv_, mu, logvar)),
        B, T, C, int(seq), E, Lz, max(act), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "fused_encode")
    launches += 1
    return mu, logvar


class _FusedEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, codes, *params):
        ctx.cfg = cfg
        ctx.save_for_backward(codes, *params)
        if codes.device.type == "cpu":
            cd = matmul_dtype(cfg, codes.device)
            return encode_with(cfg, one_hot(codes, cfg.charset_size), params, cd)
        return _encode_kernel(cfg, codes, params)

    @staticmethod
    def backward(ctx, g_mu, g_logvar):
        codes, *params = ctx.saved_tensors
        cfg = ctx.cfg
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in params]
            mu, logvar = encode_with(
                cfg, one_hot(codes, cfg.charset_size), leaves, matmul_dtype(cfg, codes.device)
            )
            grads = torch.autograd.grad((mu, logvar), leaves, (g_mu, g_logvar))
        return (None, None, *grads)


def fused_encode(model, cfg, codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """codes (B, T) integer -> (mu, logvar) (B, latent) fp32, differentiable
    in the model's encoder weights."""
    return _FusedEncode.apply(cfg, codes, *encoder_params(model))
