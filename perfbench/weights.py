"""Weights from ``--seed``, made on the device in one draw.

Every parameter of the configuration (``reference.model.param_shapes``) is
uniform in +-1/sqrt(fan_in), fp32 (the type the program keeps its weights
in), cut from one ``torch.rand`` on the device's own generator. The same
seed gives the same weights on the same device, so the program and the
reference are handed the same dictionary.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.model import param_shapes

_SALT = 0x3EED_0001


def make(sizes: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(sizes)
    total = sum(math.prod(shape) for _, shape, _ in shapes)
    gen = torch.Generator(device=device).manual_seed((seed * 2 + 1) ^ _SALT)
    u = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, bound in shapes:
        n = math.prod(shape)
        out[name] = u[off:off + n].view(shape).mul(2.0 * bound).sub_(bound)
        off += n
    return out
