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


class PinnedStaging:
    """Host-to-device copies through a ring of pinned host buffers.

    ``copy(shape, dtype, fill)`` waits until the ring's next buffer is free
    (the CUDA event recorded after the last copy out of it), lets ``fill``
    write the host data straight into it (a numpy view), and queues a
    non-blocking copy to the device, into ``out`` or a new device tensor,
    on the current stream. With two buffers the host prepares the next
    batch while the card still copies the last one, and never rewrites a
    buffer that a copy is still reading. Waiting on an event is not a
    stream or device synchronisation (``torch.cuda.set_sync_debug_mode``
    lets it pass); in steady state the event has long completed."""

    def __init__(self, device: Union[str, torch.device], slots: int = 2):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"PinnedStaging: {self.device} is not a CUDA device")
        self._bufs = [None] * slots
        self._events = [None] * slots
        self._next = 0

    def copy(self, shape, dtype: torch.dtype, fill, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()
        buf = self._bufs[i]
        if buf is None or tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
            buf = self._bufs[i] = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
        fill(buf.numpy())
        if out is None:
            out = torch.empty(tuple(shape), dtype=dtype, device=self.device)
        out.copy_(buf, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._events[i] = event
        return out
