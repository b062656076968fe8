"""The integer-op floor probe: wrapper and plain version.

Port of ``bench/auto_loop_probe.py::floor_loop`` (``_floor_kernel``), the
TPU probe of what one native int32 op costs inside a kernel loop, which was
the floor for an automaton written as vector ops. ``floor_loop`` launches
``csrc/floor.cu`` (one thread per element and chain, the chains of an
element summed by warp shuffles) for CUDA tensors and runs
``floor_loop_ref`` for CPU tensors; the two agree bit for bit. T, k_ops and
chains are runtime arguments of the kernel, so the loop cannot be folded:
the time per op comes from differencing two k_ops.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches made by the wrapper (not by the plain version)
launches = 0

MAX_CHAINS = 8  # csrc/floor.cu instantiates 1 .. 8 chains


def _check(x: torch.Tensor, T: int, k_ops: int, chains: int) -> None:
    if x.dtype != torch.int32:
        raise ValueError(f"floor_loop: x must be int32, got {x.dtype}")
    if T < 0 or k_ops < 0 or not 1 <= chains <= MAX_CHAINS:
        raise ValueError(f"floor_loop: T={T}, k_ops={k_ops}, chains={chains} (1..{MAX_CHAINS})")


def floor_loop_ref(x: torch.Tensor, T: int, k_ops: int, chains: int = 4) -> torch.Tensor:
    """``_floor_kernel``'s function in torch int32 ops, on any device:
    chains c = x + c; each step t applies k_ops ops y = where(y > t, y - 1,
    y + 1), op i to chain i % chains; returns the sum of the chains (int32,
    wrapping). The ops of one round (one op per chain) run as one tensor
    op."""
    _check(x, T, k_ops, chains)
    ys = x[None] + torch.arange(chains, dtype=torch.int32, device=x.device).view(-1, *([1] * x.dim()))
    for t in range(T):
        for i in range(0, k_ops, chains):
            y = ys[: min(chains, k_ops - i)]
            y.copy_(torch.where(y > t, y - 1, y + 1))
    return ys.sum(0, dtype=torch.int32)


def floor_loop(x: torch.Tensor, T: int, k_ops: int, chains: int = 4) -> torch.Tensor:
    """``floor_loop_ref`` on the card: one launch of ``molvax_floor_loop``
    over x's elements (int32, any shape) and their chains, or the plain
    version for a CPU tensor. Returns an int32 tensor of x's shape."""
    global launches
    _check(x, T, k_ops, chains)
    if x.device.type == "cpu":
        return floor_loop_ref(x, T, k_ops, chains)
    if x.device.type != "cuda":
        raise ValueError(f"floor_loop: unsupported device {x.device}")
    x_ = x.contiguous()
    out = torch.empty_like(x_)
    if x_.numel() == 0:
        return out
    fn = _build.function("molvax_floor_loop", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    err = fn(x_.data_ptr(), out.data_ptr(), x_.numel(), T, k_ops, chains,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "floor_loop")
    launches += 1
    return out
