"""Profiling and timing for the port (``trace`` and ``step_timer`` port
``molvax/train/profiling.py``'s):

  * ``trace(log_dir)``: ``torch.profiler`` over host and CUDA activity,
    writing a Chrome trace (``chrome://tracing``, perfetto.dev) into log_dir;
    the program's own spans (``utils.span``, ``molvax:<name>``) are in it;
  * ``Peaks`` and ``H100_SXM``, the card's published peaks, and ``bound_ms``
    (the least time the card could take for a kernel's work);
  * ``step_timer``: median seconds per call, draining the card's queue with
    ``torch.cuda.synchronize()``; ``event_ms``: median ms of single launches
    between CUDA events;
  * ``card_line``: the card's name and power limit, to print beside times.

The benchmark's yardstick (operations, bytes and peaks by card name) is
``perfbench/yardstick.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import subprocess
import time
from typing import Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Published dense peaks of one card at its full power limit."""

    bf16_tflops: float  # tensor cores, bf16 and fp16
    fp32_tflops: float  # fp32 outside the tensor cores
    int32_tops: float  # int32 operations: half the fp32 lane rate
    hbm_tb_s: float  # device memory bandwidth
    tf32_tflops: float  # tensor cores, TF32 (a 3xTF32 product runs three of them)


# NVIDIA's data sheet for the H100 SXM (dense rates without sparsity, 700 W)
H100_SXM = Peaks(bf16_tflops=989.0, fp32_tflops=67.0, int32_tops=33.5, hbm_tb_s=3.35, tf32_tflops=494.7)


def bound_ms(ops: float, moved: float, ops_per_s: float) -> Tuple[float, str]:
    """The least time in ms an H100 SXM could take for work of ``ops``
    operations, at ``ops_per_s`` for their type, that moves ``moved`` bytes
    (each input read once, each output written once) at ``H100_SXM``'s
    memory rate: the larger of the two times, and what binds ('operations'
    or 'bytes'). Bounds are against the published peaks, whatever the card's
    power limit."""
    t_ops, t_bytes = ops / ops_per_s * 1e3, moved / (H100_SXM.hbm_tb_s * 1e12) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/trace'): run_steps()`` writes
    ``trace_<time>_<pid>.json`` into log_dir; CUDA activity is traced where
    there is a card. Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    name = f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def _drain(_out) -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def step_timer(
    step_fn: Callable,
    *args,
    steps: int = 10,
    rounds: int = 3,
    fetch: Optional[Callable] = None,
) -> float:
    """Median seconds per call of ``step_fn(*args)``: one untimed call,
    then ``rounds`` rounds of ``steps`` calls, each round ended by
    ``fetch(out)`` (default: ``torch.cuda.synchronize()``, so the card's
    queue is drained inside the timed region); the median of the rounds
    after the first (of the only one if rounds == 1)."""
    fetch = fetch or _drain
    out = step_fn(*args)
    fetch(out)
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(steps):
            out = step_fn(*args)
        fetch(out)
        times.append((time.perf_counter() - t0) / steps)
    return float(statistics.median(times[1:] if len(times) > 1 else times))


def event_ms(fn: Callable, warmup: int = 2, reps: int = 5) -> float:
    """Median ms of ``fn()`` between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()
