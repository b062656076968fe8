"""The GRU kernel router of the training decode.

Port of the router of ``molvax/kernels/gru.py:856-938``
(``gru_forward_pallas``). bf16 stacks that ``stack_plan_ok`` accepts take the
fused stack kernels (``kernels/gru_stack.py``). Everything else, strict
fp32, single-layer or non-uniform stacks, and configs pinned to
``gru_kernel='per_layer'``, takes the per-layer kernel ``gru_layer_scan_x``
in the reference, which is not ported yet: on CUDA the router raises, and
on the CPU it runs the plain sweep (``nn.gru.gru_forward``). The TPU-only
batch-size fallback (``pallas_batch_ok``) is dropped: the CUDA kernels take
any batch.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..nn.gru import gru_forward
from . import gru_stack

PER_LAYER_TODO = (
    "the per-layer GRU kernel gru_layer_scan_x (strict fp32, single-layer and "
    "non-uniform stacks, gru_kernel='per_layer') is not ported yet: ROADMAP "
    "queue B, 'gru_layer_scan_x'"
)


def _on_cuda(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def gru_forward_pallas(
    layers: List[dict],
    x_seq: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    kernel: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``nn.gru.gru_forward`` through the hand-written kernels:
    x_seq (B, T, in) -> (out (B, T, H), h_final (L, B, H)).

    ``kernel`` is ``ModelConfig.gru_kernel``: 'auto' and 'fused_stack' take
    the stack kernels where they apply, 'per_layer' never does."""
    if (
        compute_dtype == torch.bfloat16
        and kernel != "per_layer"
        and gru_stack.stack_plan_ok(layers)
    ):
        return gru_stack.gru_forward_wavefront(layers, x_seq, h0)
    if _on_cuda(x_seq):
        raise NotImplementedError(PER_LAYER_TODO)
    return gru_forward(layers, x_seq, h0, compute_dtype)
