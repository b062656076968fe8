"""Fused conv encoder: wrapper and plain version.

Port of ``molvax/kernels/conv_enc.py:114-205``. ``fused_encode`` maps codes
(B, T) to (mu, logvar) in one cooperative launch of the hand-written kernel
``csrc/conv_enc.cu``: the conv stack a warp per row (the first conv a
gather by the codes, the later ones on the tensor cores), the dense layer
and the heads in row tiles, a grid barrier between the phases. The kernel
reads the model's own fp32 parameters and the codes in their own integer
type, so the wrapper prepares nothing: it allocates the outputs and the
scratch and launches. Its plain version is the port's encoder on the
one-hot (``fused_encode_ref``), which rounds where the kernel rounds: bf16
operands, bf16 between the conv stages, fp32 heads. The gradient, as in the
reference, is autograd of the plain encoder, recomputed in the backward on
cuDNN's deterministic algorithms, so a train step gives the same bits
every run.
For CUDA tensors the forward launches the kernel or raises; the plain
version runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..data.featurize import one_hot
from ..nn.encoder import conv_spatial_len, encode_with, encoder_params
from ..utils import matmul_dtype
from . import _build, gru_stack

# kernel launches made by fused_encode (not by the plain version)
launches = 0

MAX_CONV = 8  # csrc/conv_enc.cuh MAX_CONV
NO_LAYOUT = 1000  # csrc/conv_enc.cu ENC_NO_LAYOUT
# the codes' integer types, as csrc/conv_enc.cuh CodeKind numbers them
CODE_KINDS = {torch.uint8: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3, torch.int64: 4}


def fused_encode_ref(model, cfg, codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the port's encoder on ``one_hot(codes)``."""
    return encode_with(
        cfg, one_hot(codes, cfg.charset_size), encoder_params(model), matmul_dtype(cfg, codes.device)
    )


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def scratch_bytes(cfg, B: int) -> int:
    """Bytes of the kernel's scratch: h3 (B, Fp) bf16, 16-byte aligned, then
    h2 (B, Ep) fp32, with Fp = F rounded up to 16 and Ep = E to 8."""
    F = cfg.conv_channels[-1] * conv_spatial_len(cfg)
    return _up(B * _up(F, 16) * 2, 16) + B * _up(cfg.enc_hidden, 8) * 4


def _check_device(codes: torch.Tensor, params) -> None:
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"fused_encode: unsupported device {dev}")
    if any(p.device != dev for p in params):
        raise ValueError("fused_encode: model and codes are on different devices")


def _encode_kernel(cfg, codes: torch.Tensor, params) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    _check_device(codes, params)
    n_conv = len(cfg.conv_channels)
    B, T, C = codes.shape[0], cfg.max_len, cfg.charset_size
    if codes.dim() != 2 or codes.shape[1] != T or B == 0:
        raise ValueError(f"fused_encode: codes must be (B>0, {T}), got {tuple(codes.shape)}")
    if codes.dtype not in CODE_KINDS or not codes.is_contiguous():
        raise ValueError(f"fused_encode: codes must be a contiguous integer tensor, got {codes.dtype}")
    if not 1 <= n_conv <= MAX_CONV:
        raise ValueError(f"fused_encode: {n_conv} convs; the kernel takes 1 to {MAX_CONV}")
    if any(p.dtype != torch.float32 or not p.is_contiguous() for p in params):
        raise ValueError("fused_encode: the encoder's parameters must be contiguous fp32")
    conv_spatial_len(cfg)  # raises if the convs consume the axis
    w0, b0, w_mu, b_mu, w_lv, b_lv = params[2 * n_conv :]
    E, Lz = w0.shape[0], w_mu.shape[0]
    dev = codes.device
    mu = torch.empty(B, Lz, device=dev)
    logvar = torch.empty(B, Lz, device=dev)
    scratch = torch.empty(scratch_bytes(cfg, B), dtype=torch.uint8, device=dev)
    ptrs, ints = ctypes.c_void_p * n_conv, ctypes.c_int * n_conv
    fn = _build.function(
        "molvax_fused_encode",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    )
    sms, smem = gru_stack.plan_limits(dev)
    err = fn(
        codes.data_ptr(), CODE_KINDS[codes.dtype],
        ptrs(*(params[2 * i].data_ptr() for i in range(n_conv))),
        ptrs(*(params[2 * i + 1].data_ptr() for i in range(n_conv))),
        n_conv, ints(*cfg.conv_channels), ints(*cfg.conv_kernels),
        *(t.data_ptr() for t in (w0, b0, w_mu, b_mu, w_lv, b_lv, mu, logvar, scratch)),
        B, T, C, int(cfg.conv_orientation == "seq"), E, Lz, sms, smem,
        gru_stack._stream(codes),
    )
    if err == NO_LAYOUT:
        raise ValueError(f"fused_encode: no layout of the kernel fits {smem} bytes of shared memory a block")
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
        # cuDNN's deterministic algorithms only: its default conv weight
        # gradient sums in an order that varies from run to run, so two
        # runs of a step (or a step and its CUDA Graph replay) would differ
        cudnn = torch.backends.cudnn
        with torch.enable_grad(), cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                                              benchmark_limit=cudnn.benchmark_limit, deterministic=True,
                                              allow_tf32=cudnn.allow_tf32):
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
