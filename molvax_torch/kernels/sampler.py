"""Fused reparameterization sampler + KL: wrapper, plain version, backward.

Port of ``molvax/kernels/sampler.py:37-135``. ``fused_sample_kl`` draws eps,
forms z = mu + eps_scale * exp(logvar / 2) * eps and the per-row KL in one
launch of the hand-written kernel ``csrc/sampler.cu``; ``fused_sample_kl_ref``
is the same math in plain torch ops. eps comes from the counter hash of the
generation kernel (``kernels.generate.noise_bits``, key (seed, draw, row,
dim)) through Box-Muller on two 24-bit uniforms, so the kernel and the plain
version draw identical bits. The kernel reads the seed from device memory
(a one-element integer tensor), so a train step can take its seed from a
vector on the card and a CUDA Graph of steps replays with new seeds. Like the TPU kernel's on-chip PRNG, the stream
is seed-deterministic and differs from ``jax.random``'s. The backward is
the closed form of the reference (``sample_kl_backward``), in plain torch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple, Union

import torch

from . import _build, gru_stack
from .generate import noise_bits, seed_word

# kernel launches made by fused_sample_kl (not by the plain version)
launches = 0


Seed = Union[int, torch.Tensor]


def sample_eps(seed: Seed, batch: int, dim: int, device, row_base: int = 0) -> torch.Tensor:
    """(batch, dim) fp32 standard normals of ``seed``: Box-Muller on
    u1 = (top24(bits(seed, 0, row, d)) + 1) / 2**24 in (0, 1] and
    u2 = top24(bits(seed, 1, row, d)) / 2**24 in [0, 1), for the global
    rows ``row_base`` .. ``row_base + batch - 1`` (a data-parallel rank's
    rows of the global batch; 0 in one process)."""
    rows = torch.arange(row_base, row_base + batch, dtype=torch.int64, device=device)[:, None]
    dims = torch.arange(dim, dtype=torch.int64, device=device)[None, :]
    scale = 1.0 / (1 << 24)
    u1 = ((noise_bits(seed, 0, rows, dims) >> 8).to(torch.float32) + 1.0) * scale
    u2 = (noise_bits(seed, 1, rows, dims) >> 8).to(torch.float32) * scale
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


def fused_sample_kl_ref(
    seed: Seed, mu: torch.Tensor, logvar: torch.Tensor, eps_scale: float = 1.0, row_base: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: (z (B, L), kl (B,)), fp32. Differentiable by
    autograd, which gives the closed form of ``sample_kl_backward``.
    ``seed``: a Python int, or a one-element integer tensor on mu's device
    (the kernel's operand), which gives the same bits. ``row_base``: the
    global index of mu's first row (``sample_eps``)."""
    eps = sample_eps(seed, mu.shape[0], mu.shape[1], mu.device, row_base)
    z = mu + eps_scale * torch.exp(0.5 * logvar) * eps
    kl = -0.5 * torch.sum(1.0 + logvar - mu * mu - torch.exp(logvar), dim=-1)
    return z, kl


def sample_kl_backward(z, mu, logvar, g_z, g_kl) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form cotangents of (mu, logvar) (``_fs_bwd`` of the reference):
    dz/dmu = 1, dz/dlogvar = (z - mu) / 2, dKL/dmu = mu,
    dKL/dlogvar = -(1 - exp(logvar)) / 2."""
    d_mu = g_z + g_kl[:, None] * mu
    d_logvar = g_z * 0.5 * (z - mu) + g_kl[:, None] * (-0.5) * (1.0 - torch.exp(logvar))
    return d_mu, d_logvar


def _check_device(mu: torch.Tensor, logvar: torch.Tensor) -> None:
    if mu.device.type != "cuda":
        raise ValueError(f"fused_sample_kl: unsupported device {mu.device}")
    if logvar.device != mu.device:
        raise ValueError("fused_sample_kl: mu and logvar are on different devices")


def _sample_kernel(seed: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor, eps_scale: float,
                   row_base: int = 0):
    """One launch of the kernel; ``seed`` a one-element int32 or int64
    tensor on mu's device, read by the kernel as its low 32 bits;
    ``row_base`` the global index of mu's first row, a 32-bit scalar."""
    global launches
    _check_device(mu, logvar)
    if mu.dim() != 2 or mu.shape != logvar.shape or mu.shape[0] == 0:
        raise ValueError(f"fused_sample_kl: mu {tuple(mu.shape)} and logvar {tuple(logvar.shape)}")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in (mu, logvar)):
        raise ValueError("fused_sample_kl: mu and logvar must be contiguous fp32")
    if (not isinstance(seed, torch.Tensor) or seed.numel() != 1 or seed.device != mu.device
            or seed.dtype not in (torch.int32, torch.int64)):
        raise ValueError("fused_sample_kl: the seed must be a one-element int32 or int64 tensor on mu's device")
    B, L = mu.shape
    z = torch.empty(B, L, device=mu.device)
    kl = torch.empty(B, device=mu.device)
    fn = _build.function(
        "molvax_fused_sample_kl",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_uint32,
                                                       ctypes.c_void_p],
    )
    err = fn(
        mu.data_ptr(), logvar.data_ptr(), z.data_ptr(), kl.data_ptr(), B, L, seed.data_ptr(),
        float(eps_scale), row_base & 0xFFFFFFFF, gru_stack._stream(mu),
    )
    _build.check(err, "fused_sample_kl")
    launches += 1
    return z, kl


class _FusedSampleKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, seed, mu, logvar, eps_scale, row_base):
        if mu.device.type == "cpu":
            z, kl = fused_sample_kl_ref(seed, mu, logvar, eps_scale, row_base)
        else:
            if not isinstance(seed, torch.Tensor):
                seed = seed_word(seed, mu.device)
            z, kl = _sample_kernel(seed, mu, logvar, eps_scale, row_base)
        ctx.save_for_backward(z, mu, logvar)
        return z, kl

    @staticmethod
    def backward(ctx, g_z, g_kl):
        return (None, *sample_kl_backward(*ctx.saved_tensors, g_z, g_kl), None, None)


def fused_sample_kl(
    seed: Seed, mu: torch.Tensor, logvar: torch.Tensor, eps_scale: float = 1.0, row_base: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(seed, mu, logvar) -> (z, per-row KL), differentiable in mu and
    logvar. ``seed``: a one-element integer tensor on mu's device (the train
    step's, read from its schedule vector), or a Python int, which a CUDA
    call first puts on the card (a fill, no copy from the host).
    ``row_base``: the global index of mu's first row, so that a
    data-parallel rank draws the eps of its rows of the global batch."""
    return _FusedSampleKL.apply(seed, mu, logvar, eps_scale, row_base)
