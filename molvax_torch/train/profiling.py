"""Profiling, FLOP accounting and timing for the port.

Port of ``molvax/train/profiling.py``, in PyTorch's idiom:
  * ``trace(log_dir)``: ``torch.profiler`` over host and CUDA activity,
    writing a Chrome trace (``chrome://tracing``, perfetto.dev) into log_dir;
  * ``annotate(name)``: a named span in that trace
    (``torch.profiler.record_function``);
  * ``cost_summary(fn, *args)``: the FLOPs ``FlopCounterMode`` counts in one
    call of fn, and the compute-bound time at the card's bf16 peak. The
    hand-written kernels are invisible to the counter, as the Pallas calls
    are to XLA's, so treat the figure as a lower bound;
  * ``forward_flops_per_smiles`` / ``train_flops_per_smiles``: matmul FLOPs
    counted by hand from a ``ModelConfig``, equal to the reference's;
  * ``device_peak_tflops`` and the peak table, ``mfu``, ``bound_ms`` (the
    least time the card could take for a kernel's work);
  * ``step_timer``: median seconds per call, draining the card's queue with
    ``torch.cuda.synchronize()`` where the reference fetched to the host;
    ``event_ms``: median ms of single launches between CUDA events;
  * ``card_line``: the card's name and power limit, to print beside times.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import subprocess
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..utils import resolve_device


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

# by the name torch.cuda.get_device_name reports
PEAKS = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
}


def bound_ms(ops: float, moved: float, ops_per_s: float) -> Tuple[float, str]:
    """The least time in ms an H100 SXM could take for work of ``ops``
    operations, at ``ops_per_s`` for their type, that moves ``moved`` bytes
    (each input read once, each output written once) at ``H100_SXM``'s
    memory rate: the larger of the two times, and what binds ('operations'
    or 'bytes'). Bounds are against the published peaks, whatever the card's
    power limit."""
    t_ops, t_bytes = ops / ops_per_s * 1e3, moved / (H100_SXM.hbm_tb_s * 1e12) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_peak_tflops(device=None) -> Optional[float]:
    """bf16 peak TFLOP/s of ``device`` (None: the card), or None if unknown
    or a CPU. ``MOLVAX_PEAK_TFLOPS`` overrides the table, as in the
    reference."""
    env = os.environ.get("MOLVAX_PEAK_TFLOPS")
    if env:
        return float(env)
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    peaks = PEAKS.get(torch.cuda.get_device_name(dev))
    return peaks.bf16_tflops if peaks else None


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


def annotate(name: str):
    """Label a region in the profiler timeline."""
    return torch.profiler.record_function(name)


def cost_summary(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """FLOPs of one call ``fn(*args, **kwargs)`` (it runs) as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them: matrix
    products, convolutions and attention, not elementwise work. Where the
    peak of the first tensor argument's device is known, also ``sol_step_s``,
    the FLOPs over the bf16 peak. Hand-written kernels are invisible to the
    counter, so both are lower bounds."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    out = {"flops": float(counter.get_total_flops())}
    device = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    peak = device_peak_tflops(device)
    if peak:
        out["sol_step_s"] = out["flops"] / (peak * 1e12)
    return out


def forward_flops_per_smiles(cfg) -> float:
    """Analytic matmul FLOPs of one forward pass, per sample, counted from
    the architecture (``ModelConfig``) as the reference counts them: the
    hot recurrence runs in hand-written kernels that no counter sees into.
    Elementwise gate math is excluded (the MFU convention counts matmul
    FLOPs only)."""
    T, C, L, H = cfg.max_len, cfg.charset_size, cfg.latent_dim, cfg.gru_hidden
    f = 0.0
    # conv stack (orientation 'seq': conv along T, charset = in channels)
    if cfg.conv_orientation == "seq":
        length, in_ch = T, C
    else:
        length, in_ch = C, T
    for ch, k in zip(cfg.conv_channels, cfg.conv_kernels):
        length = length - k + 1
        f += 2.0 * length * ch * in_ch * k
        in_ch = ch
    flat = length * in_ch
    f += 2.0 * flat * cfg.enc_hidden  # linear_0
    f += 2.0 * cfg.enc_hidden * L * 2  # mu, logvar heads
    f += 2.0 * L * L  # decoder linear_3
    gru_in = L + C if cfg.decoder_conditioning == "teacher_forced" else L
    for layer in range(cfg.gru_layers):
        in_size = gru_in if layer == 0 else H
        f += 2.0 * T * (in_size + H) * 3 * H  # input + hidden gate GEMMs
    f += 2.0 * T * H * C  # output projection
    if cfg.n_properties > 0:
        f += 2.0 * (L * cfg.property_hidden + cfg.property_hidden * cfg.n_properties)
    return f


def train_flops_per_smiles(cfg) -> float:
    """Matmul FLOPs of one training step, per sample: forward + backward
    (each GEMM again for dX and dW), 3x forward."""
    return 3.0 * forward_flops_per_smiles(cfg)


def mfu(smiles_per_sec: float, cfg, device=None) -> Dict[str, float]:
    """Model-FLOPs utilization from a measured training throughput:
    {flops_per_smiles, tflops_sustained, mfu}; mfu is 0 where the device's
    peak is unknown (sustained TFLOP/s is reported regardless)."""
    fps = train_flops_per_smiles(cfg)
    sustained = fps * smiles_per_sec / 1e12
    peak = device_peak_tflops(device)
    return {
        "flops_per_smiles": fps,
        "tflops_sustained": sustained,
        "mfu": (sustained / peak) if peak else 0.0,
    }


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
