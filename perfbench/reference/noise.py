"""The counter hash behind every draw of a training step, frozen.

A step's seed comes from the run's base seed and the step number, and the
reparameterisation noise of batch row r, latent dimension d from the seed
through a 32-bit integer hash (lowbias32, as the program's CUDA sampler
computes it) and Box-Muller. The reference works the noise out again from
these functions alone; it never reads the program's noise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) held in int64, with no int64
    overflow: x split into 16-bit halves."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * (c & 0xFFFF)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on int64 tensors holding 32-bit words."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def fold_in(seed: int, data: int) -> int:
    """A new 32-bit seed from (seed, data): mix32(mix32(seed) + data)."""
    h = mix32(torch.tensor(seed & MASK32, dtype=torch.int64))
    return int(mix32((h + (data & MASK32)) & MASK32))


def step_seeds(base_seed: int, start: int, count: int) -> np.ndarray:
    """The seeds of steps ``start`` .. ``start + count - 1`` as uint32."""
    return np.array([fold_in(base_seed, start + i) for i in range(count)], dtype=np.uint32)


def bits(seed: int, draw: int, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """uint32 words (in int64) of draw ``draw`` for every (row, col) pair;
    ``rows`` (R, 1) and ``cols`` (1, N) broadcast."""
    h = mix32(torch.full((), seed & MASK32, dtype=torch.int64, device=rows.device))
    h = mix32((h + rows) & MASK32)
    h = mix32((h + draw) & MASK32)
    return mix32((h + cols) & MASK32)


def normal(seed: int, batch: int, dim: int, device) -> torch.Tensor:
    """(batch, dim) fp32 standard normals of ``seed``: Box-Muller on
    u1 = (top24(bits(seed, 0)) + 1) / 2**24 and u2 = top24(bits(seed, 1)) / 2**24."""
    rows = torch.arange(batch, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(dim, dtype=torch.int64, device=device)[None, :]
    scale = 1.0 / (1 << 24)
    u1 = ((bits(seed, 0, rows, cols) >> 8).to(torch.float32) + 1.0) * scale
    u2 = (bits(seed, 1, rows, cols) >> 8).to(torch.float32) * scale
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
