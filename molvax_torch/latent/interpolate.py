"""Latent interpolation between molecules (lerp / slerp).

Port of ``molvax/latent/interpolate.py``: encode two SMILES, walk the
latent segment between their means, decode each waypoint. Slerp is the
path under a Gaussian prior (high-dimensional Gaussians concentrate on a
shell, so linear midpoints fall off it); lerp is kept for the reference
lineage's behaviour.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..data.alphabet import DEFAULT_CHARSET, Charset, strings
from .embed import posterior_of
from .sample import generate


def lerp(z0: torch.Tensor, z1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return z0 * (1.0 - t) + z1 * t


def slerp(z0: torch.Tensor, z1: torch.Tensor, t: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Spherical interpolation of the direction on the shell through z0 and
    z1, the norm interpolated linearly beside it."""
    n0 = torch.linalg.norm(z0, dim=-1, keepdim=True)
    n1 = torch.linalg.norm(z1, dim=-1, keepdim=True)
    u0, u1 = z0 / (n0 + eps), z1 / (n1 + eps)
    omega = torch.arccos(torch.clamp(torch.sum(u0 * u1, dim=-1, keepdim=True), -1 + eps, 1 - eps))
    so = torch.sin(omega)
    w0 = torch.sin((1.0 - t) * omega) / (so + eps)
    w1 = torch.sin(t * omega) / (so + eps)
    norm = n0 * (1.0 - t) + n1 * t
    return (w0 * u0 + w1 * u1) * norm


def interpolate(
    model,
    cfg,
    smiles_a: str,
    smiles_b: str,
    steps: int = 10,
    generator: Optional[torch.Generator] = None,
    charset: Charset = DEFAULT_CHARSET,
    spherical: bool = True,
    constrained: bool = False,
) -> List[str]:
    """Decode ``steps`` waypoints, the endpoints' means included, greedily
    (``latent.sample.generate``); ``constrained=True`` decodes each under
    the valence automaton, so every point of the path is chemically valid."""
    mu, _ = posterior_of(model, cfg, [smiles_a, smiles_b], charset)
    t = torch.linspace(0.0, 1.0, steps, device=mu.device)[:, None]
    zs = (slerp if spherical else lerp)(mu[0][None, :], mu[1][None, :], t)
    out_codes, _ = generate(model, cfg, zs, generator, greedy=True, constrained=constrained, charset=charset)
    return strings(out_codes, cfg, charset)
