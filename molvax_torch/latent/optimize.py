"""Gradient-based property optimization in latent space.

Port of ``molvax/latent/optimize.py``: from an encoded molecule (or any
z), ascend the property head's prediction by gradient in z (torch
autograd, one step after another where the reference scans jitted steps),
with a Gaussian-prior penalty keeping z decodable; then decode.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from ..data.alphabet import strings
from ..nn.property_head import denormalize_properties, predict_properties
from .embed import posterior_of
from .sample import generate


class OptimizeResult(NamedTuple):
    z: torch.Tensor  # (B, L) final latents
    objective: torch.Tensor  # (B,) final objective values
    trajectory: torch.Tensor  # (steps, B) objective after each gradient step
    objective_start: torch.Tensor  # (B,) objective at the seed z0 (before any step)


def default_objective(cfg, property_index: int = 0, sign: float = 1.0) -> Callable:
    """Maximize (sign=+1) or minimize (sign=-1) one property-head output,
    in raw property units (the head's outputs de-normalized with the
    training stats in ``cfg``: an affine map with std > 0, so the ascent
    direction is the normalized output's)."""

    def objective(model, z: torch.Tensor) -> torch.Tensor:
        props = denormalize_properties(cfg, predict_properties(model, cfg, z))
        return sign * props[..., property_index]

    return objective


def optimize_z(
    model,
    cfg,
    z0: torch.Tensor,
    objective: Optional[Callable] = None,
    steps: int = 100,
    lr: float = 0.05,
    prior_weight: float = 1e-3,
) -> OptimizeResult:
    """Gradient-ascend ``objective(model, z)`` from z0 (B, L): z <- z + lr *
    grad, the gradient of sum(objective + reg) with reg = -prior_weight *
    ||z||^2 / 2 (the Gaussian prior's log-density). The model is not
    updated."""
    if objective is None:
        objective = default_objective(cfg)

    def value_and_grad(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            obj = objective(model, z)
            reg = -0.5 * prior_weight * torch.sum(z * z, dim=-1)
            (g,) = torch.autograd.grad(torch.sum(obj + reg), z)
        return obj.detach(), g

    z = z0.detach().float()
    obj_start, g = value_and_grad(z)
    obj, traj = obj_start, []
    for _ in range(steps):
        z = z + lr * g
        obj, g = value_and_grad(z)
        traj.append(obj)
    trajectory = torch.stack(traj) if traj else obj_start.new_empty((0, z.shape[0]))
    return OptimizeResult(z=z, objective=obj, trajectory=trajectory, objective_start=obj_start)


def optimize_from_smiles(
    model,
    cfg,
    smiles: List[str],
    generator: Optional[torch.Generator] = None,
    objective: Optional[Callable] = None,
    steps: int = 100,
    lr: float = 0.05,
    charset=None,
    constrained: bool = False,
) -> Tuple[List[str], OptimizeResult]:
    """Encode the seeds -> optimize -> greedy decode. Returns (smiles_out,
    result); ``constrained=True`` decodes under the valence automaton, so
    the strings are chemically valid by construction."""
    mu, _ = posterior_of(model, cfg, smiles, charset)
    result = optimize_z(model, cfg, mu, objective=objective, steps=steps, lr=lr)
    out_codes, _ = generate(model, cfg, result.z, generator, greedy=True, constrained=constrained, charset=charset)
    return strings(out_codes, cfg, charset), result
