"""Device and dtype resolution for the port, its profiler spans, the
CUDA Graph capture that the train chunk and the scan decode share
(``capture_graph``), and the debug guards.

``span(name)`` marks a region of the program's host work in a running
``torch.profiler`` trace as ``molvax:<name>``, on the clock of the device
activity it records. With no profiler running it is one shared null
context and calls no torch op, so a span may sit in a per-step host loop.

The guards (``debug_mode``, ``assert_finite``, ``checked``) are the
reference's ``molvax/utils.py`` in torch's idiom: anomaly detection makes a
backward fail at the op that produced a NaN, and a finiteness check on a
tensor tree raises at the first non-finite leaf. Both sync with the host, so
they are development tools: never leave them on a hot path.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, Callable, Optional, Tuple, Union

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


SPAN_PREFIX = "molvax:"
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``with span("sample.step"): ...``: the region as ``molvax:<name>``
    in whatever ``torch.profiler`` is running (the benchmark's, the
    operator's ``train.profiling.trace``, a user's own); the null context
    when none is."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


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
    lets it pass); in steady state the event has long completed. Where
    the ring has a ``wait_span`` name, that wait is a span of that name: the
    time the host is held back by copies still in the card's queue."""

    def __init__(self, device: Union[str, torch.device], slots: int = 2, wait_span: Optional[str] = None):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"PinnedStaging: {self.device} is not a CUDA device")
        self.wait_span = wait_span
        self._bufs = [None] * slots
        self._events = [None] * slots
        self._next = 0

    def copy(self, shape, dtype: torch.dtype, fill, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            with _NO_SPAN if self.wait_span is None else span(self.wait_span):
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


def capture_graph(device: Union[str, torch.device], warm: Callable[[], None],
                  body: Callable[[], Any]) -> Tuple[torch.cuda.CUDAGraph, Any, float]:
    """``body`` captured in one CUDA Graph on a side stream, after ``warm``
    ran there for real: the warm work loads the kernel library and makes
    cuBLAS' workspace for that stream, so that nothing in the capture is
    made from host data. (the graph, what ``body`` returned, the seconds
    the capture took, instantiation included)."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        warm()
    torch.cuda.current_stream(device).wait_stream(stream)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, stream=stream):
        out = body()
    return graph, out, time.perf_counter() - t0


@contextlib.contextmanager
def debug_mode(nans: bool = True, tracer_leaks: bool = False):
    """``with debug_mode(): train(...)``: fail fast at the first NaN.

    ``nans`` turns on ``torch.autograd.set_detect_anomaly``, so a backward
    raises at the op whose gradient is NaN and names the forward op that
    made it; the previous setting comes back on exit. ``tracer_leaks`` has
    no effect: eager torch has no tracers to leak (the argument stays for
    the reference's call pattern, as ``ModelConfig.use_pallas_automaton``
    does)."""
    prev = torch.is_anomaly_enabled()
    try:
        torch.autograd.set_detect_anomaly(nans)
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def _leaves(tree, path: str = ""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")


def assert_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError("non-finite values in {name}{path}")`` at
    the first leaf of ``tree`` (a tensor, or dicts, lists and tuples of
    them) that holds a NaN or an infinity. Each leaf's check syncs with the
    host; under CUDA-graph capture, where a sync would break the capture,
    it raises ``RuntimeError`` instead."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"assert_finite({name}) syncs with the host and cannot run under CUDA-graph capture")
    for path, leaf in _leaves(tree):
        if not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"non-finite values in {name}{path}")


def checked(fn):
    """``fn`` wrapped for the reference's call pattern
    (``molvax.utils.checked(step)(...)``). In eager torch ``assert_finite``
    inside ``fn`` has already raised by the time ``fn`` returns, so the
    wrapper only calls it."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return fn(*args, **kwargs)

    return wrapper
