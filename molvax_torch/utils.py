"""Device and dtype resolution for the port."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card (``cuda``); a caller that wants the CPU asks
    for it (``"cpu"``), as the tests do. Asking for CUDA where there is none
    raises: the port never falls back to the CPU behind the caller's back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not available")
    return dev


def matmul_dtype(model_cfg, device: Union[str, torch.device]) -> torch.dtype:
    """Resolve ``ModelConfig.compute_dtype`` to the matmul operand dtype.

    'bfloat16' -> bf16 operands everywhere, 'float32' -> fp32 everywhere,
    'auto' -> bf16 on CUDA and fp32 on the CPU. Products always accumulate
    in fp32 (``nn.encoder.linear``)."""
    cd = model_cfg.compute_dtype
    if cd == "auto":
        return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    return torch.bfloat16 if cd == "bfloat16" else torch.float32


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round ``x`` to ``dtype`` and return it as fp32: the operand of a
    product that multiplies in ``dtype`` and accumulates in fp32 (JAX's
    ``preferred_element_type=float32``). A bf16 ``torch.matmul`` would
    round its output to bf16 as well, which the reference does not."""
    if dtype == torch.float32:
        return x.float()
    return x.to(dtype).float()
